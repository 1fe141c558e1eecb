"""Checkpoint and resume on safetensors (counterpart of
kubeflow_tpu/training/checkpoint.py, which saves through orbax, a JAX
library; the port writes its own format).

A step is the directory `<dir>/<step>/`: the tensors of the train state
as safetensors files (`models/safetensors.py`), one group of files per
top-level key (`params-00000.safetensors`, `opt_state-00000.safetensors`,
each file at most SHARD_BYTES), and `tree.json`, the tree's structure
with its host scalars (the step, the optimizer's count). The step is
written under a temporary name, every file fsynced, and renamed into
place: the rename is the commit, as orbax commits.

Which steps are saved and kept is orbax's rule, as the installed orbax's
`CheckpointManager` applies it to the JAX manager's options: a save
happens when the step is past the newest saved one and either divides by
`save_interval_steps` or no step is saved yet (orbax's initial save), or
when forced; after a save all but the newest `max_to_keep` steps are
deleted.

Integrity is the JAX manager's, helpers copied: after the commit the
step's files are hashed (sha256 each) and a manifest is written
atomically (temp file, fsync, rename, directory fsync) through the chaos
seams `io_fault("checkpoint_commit")` and `io_fault("manifest_write")`.
`latest_intact_step()` hashes each step once, quarantines corrupt steps
and unmanifested ones in a manifested tree (moved into `_quarantine/`),
and trusts a tree with no manifests at all. The port hashes a step's
files on a few threads at once (hashlib releases the interpreter lock).

A sharded state (DTensor leaves, the trainer on a mesh) is saved as whole
leaves, in the files, hashes and manifest an unsharded save of the same
state writes, so it restores onto any mesh or onto one process, as
orbax's global arrays do: rank 0 decides whether a step is saved and
every rank takes its decision, every rank gathers each leaf in turn,
rank 0 writes, and its outcome (done, or the error) is sent to every
rank, which raises with it. A restore hands each whole leaf, read one
at a time, to a `keep` that places this rank's block
(`Trainer.restore_leaf`), and `restore_or_init` takes the step rank 0
finds intact.

Saves are synchronous: the port's optimizer updates the params in place,
so `save` copies the state to the host before the next step can change
it, and returns once the step is committed and manifested. The seconds of
each part of the last save and restore are kept in `last_save` and
`last_restore`.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil
import time
from typing import Any

import torch

from kubeflow_tpu_torch.chaos.injector import io_fault
from kubeflow_tpu_torch.models import safetensors

MANIFEST_NAME = "ktpu_manifest.json"
QUARANTINE_DIR = "_quarantine"
TREE_NAME = "tree.json"
#: the largest safetensors file a step writes; more files hash and write
#: on more threads
SHARD_BYTES = 1 << 30
HASH_THREADS = 8


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write_json(path: str, obj: Any) -> None:
    """temp file in the same directory + flush + fsync + rename + dir
    fsync: the manifest either exists complete or not at all — a partial
    manifest would itself be indistinguishable from corruption."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, sort_keys=True, separators=(",", ":"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _hash_files(paths: list[str]) -> list[str]:
    """sha256 of each path, HASH_THREADS files at a time."""
    if len(paths) <= 1:
        return [_hash_file(p) for p in paths]
    with concurrent.futures.ThreadPoolExecutor(
            min(HASH_THREADS, len(paths))) as pool:
        return list(pool.map(_hash_file, paths))


def _tree_files(step_dir: str) -> list[tuple[str, str]]:
    """(relative, absolute) path of every file of a step but the
    manifest and temporaries, in a fixed order."""
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for fn in sorted(files):
            if fn == MANIFEST_NAME or fn.endswith(".tmp"):
                continue
            p = os.path.join(root, fn)
            out.append((os.path.relpath(p, step_dir), p))
    return out


def _hash_tree(step_dir: str) -> dict[str, dict[str, Any]]:
    """{relative_path: {sha256, size}} over every file of one committed
    step (the manifest body). The manifest itself is excluded."""
    files = _tree_files(step_dir)
    digests = _hash_files([p for _, p in files])
    return {rel: {"sha256": d, "size": os.path.getsize(p)}
            for (rel, p), d in zip(files, digests)}


def _all_steps(directory: str) -> list[int]:
    """The committed steps under `directory`, ascending ([] when it does
    not exist)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isdir(os.path.join(directory, n)))


def _step_dir(directory: str, step: int) -> str | None:
    """The directory of `step` (named str(step); padded variants of the
    name are tolerated, as in the JAX package)."""
    cand = os.path.join(directory, str(step))
    if os.path.isdir(cand):
        return cand
    if not os.path.isdir(directory):
        return None
    for name in os.listdir(directory):
        p = os.path.join(directory, name)
        if os.path.isdir(p) and name.isdigit() and int(name) == step:
            return p
    return None


def write_step_manifest(directory: str, step: int,
                        stats: dict[str, float] | None = None) -> bool:
    """Hash + atomically commit the manifest for one completed step.
    Returns False when the step's directory does not exist. `stats`, when
    given, receives the seconds of the hashing and of the manifest
    write."""
    step_dir = _step_dir(directory, step)
    if step_dir is None:
        return False
    t0 = time.perf_counter()
    digests = _hash_tree(step_dir)
    t1 = time.perf_counter()
    # chaos seams: "checkpoint_commit" runs after hashing (a hook that
    # corrupts a file here models a torn write / bit rot the checksum
    # must catch at restore); "manifest_write" runs before the manifest
    # lands (raising here models a crash mid-commit → a partial step)
    io_fault("checkpoint_commit", step_dir)
    io_fault("manifest_write", os.path.join(step_dir, MANIFEST_NAME))
    _atomic_write_json(os.path.join(step_dir, MANIFEST_NAME),
                       {"version": 1, "step": step, "files": digests})
    if stats is not None:
        stats["hash_s"] = t1 - t0
        stats["manifest_s"] = time.perf_counter() - t1
    return True


def verify_step(directory: str, step: int) -> str:
    """"intact" | "corrupt" | "unmanifested" | "missing" for one step."""
    step_dir = _step_dir(directory, step)
    if step_dir is None:
        return "missing"
    mpath = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return "unmanifested"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = manifest["files"]
    except (OSError, ValueError, KeyError):
        return "corrupt"
    try:
        paths = []
        for rel, meta in files.items():
            p = os.path.join(step_dir, rel)
            if not os.path.exists(p) or os.path.getsize(p) != meta["size"]:
                return "corrupt"
            paths.append(p)
        digests = _hash_files(paths)
    except OSError:
        # files vanishing mid-hash: another process quarantined this
        # step; report corrupt, the caller's fallback handles it
        return "corrupt"
    if any(d != meta["sha256"] for d, meta in zip(digests, files.values())):
        return "corrupt"
    # files that appeared since the manifest are tolerated; files that
    # vanished or changed are not
    return "intact"


def quarantine_step(directory: str, step: int) -> str | None:
    """Move a corrupt/partial step out of the step namespace (into
    `_quarantine/`), so that no later restore or fallback can read it.
    Returns the quarantine path."""
    step_dir = _step_dir(directory, step)
    if step_dir is None:
        return None
    qroot = os.path.join(directory, QUARANTINE_DIR)
    os.makedirs(qroot, exist_ok=True)
    dest = os.path.join(qroot, os.path.basename(step_dir))
    if os.path.exists(dest):
        shutil.rmtree(dest)
    try:
        os.replace(step_dir, dest)
    except OSError:
        # raced by another process quarantining the same step: keep
        # falling back, do not crash in the recovery path
        return None
    _fsync_dir(directory)
    return dest


# -- the state tree as JSON + named tensors ----------------------------------


def _flatten(node: Any, path: tuple[str, ...],
             tensors: dict[str, torch.Tensor]) -> dict[str, Any]:
    """`node` as its JSON structure; its tensors go into `tensors` under
    their "/"-joined key paths."""
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str) or "/" in k:
                raise TypeError(f"checkpoint keys must be str without '/': "
                                f"{path + (k,)}")
        return {"dict": {k: _flatten(v, path + (k,), tensors)
                         for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"list": [_flatten(v, path + (str(i),), tensors)
                         for i, v in enumerate(node)]}
    if isinstance(node, torch.Tensor):
        name = "/".join(path)
        tensors[name] = node
        return {"tensor": name}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"cannot checkpoint {type(node).__name__} at "
                    f"{'/'.join(path)}")


def _shards(names: list[str], tensors: dict[str, torch.Tensor],
            group: str) -> list[tuple[str, list[str]]]:
    """(file name, tensor names) of one top-level group, in files of at
    most SHARD_BYTES (a larger tensor gets a file of its own)."""
    out: list[tuple[str, list[str]]] = []
    cur: list[str] = []
    size = 0
    for n in names:
        nbytes = tensors[n].numel() * tensors[n].element_size()
        if cur and size + nbytes > SHARD_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(n)
        size += nbytes
    if cur:
        out.append(cur)
    return [(f"{group}-{i:05d}.safetensors", ns) for i, ns in enumerate(out)]


class _Reader:
    """Reads a stored tree into the structure of a `like` tree: tensors
    are allocated on `device` (or the like tensor's own device) from the
    like tensor's shape and dtype and filled from the step's files."""

    def __init__(self, step_dir: str, files: dict[str, str], device,
                 keep=None):
        self.step_dir = step_dir
        self.files = files
        self.device = device
        self.keep = keep
        self.nbytes = 0
        self._open: dict[str, safetensors.SafeFile] = {}

    def read(self, stored: dict[str, Any], like: Any, path: str) -> Any:
        if isinstance(like, dict):
            if "dict" not in stored or set(stored["dict"]) != set(like):
                raise ValueError(
                    f"checkpoint tree at {path or '/'} has keys "
                    f"{sorted(stored.get('dict', {}))}, the state "
                    f"{sorted(like)}")
            return {k: self.read(stored["dict"][k], v, f"{path}/{k}")
                    for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            if "list" not in stored or len(stored["list"]) != len(like):
                raise ValueError(f"checkpoint tree at {path}: not a list of "
                                 f"{len(like)}")
            return type(like)(self.read(s, v, f"{path}/{i}") for i, (s, v)
                              in enumerate(zip(stored["list"], like)))
        if isinstance(like, torch.Tensor):
            if "tensor" not in stored:
                raise ValueError(f"checkpoint tree at {path}: no tensor")
            name = stored["tensor"]
            fname = self.files[name]
            f = self._open.get(fname)
            if f is None:
                f = self._open[fname] = safetensors.SafeFile(
                    os.path.join(self.step_dir, fname))
            src = f.get_tensor(name)
            if src.shape != like.shape or src.dtype != like.dtype:
                raise ValueError(
                    f"checkpoint tensor {name}: {tuple(src.shape)} "
                    f"{src.dtype}, the state wants {tuple(like.shape)} "
                    f"{like.dtype}")
            self.nbytes += src.numel() * src.element_size()
            if self.keep is not None:
                out = self.keep(path.lstrip("/"), src)
                if out is not None:
                    return out
            dev = self.device if self.device is not None else like.device
            if torch.device(dev).type == "meta":
                raise ValueError("restoring into meta tensors needs a device")
            out = torch.empty(like.shape, dtype=like.dtype, device=dev)
            out.copy_(src)
            return out.requires_grad_(like.requires_grad)
        if "value" not in stored:
            raise ValueError(f"checkpoint tree at {path}: not a scalar")
        return stored["value"]

    def close(self) -> None:
        for f in self._open.values():
            f.close()
        self._open = {}


def _read_step(step_dir: str, like: Any, device, subtree: str | None = None,
               keep=None) -> tuple[Any, int]:
    """(state, bytes read) of one step directory, or of its `subtree`, a
    "/"-joined key path ("params", "params/lora"); only that subtree's
    files are read. `keep(path, tensor)`, when given, places each tensor
    read (None: read it as `like` says)."""
    with open(os.path.join(step_dir, TREE_NAME)) as f:
        meta = json.load(f)
    stored = meta["tree"]
    for key in (subtree.split("/") if subtree is not None else ()):
        stored = stored.get("dict", {}).get(key)
        if stored is None:
            raise ValueError(f"{step_dir} holds no {subtree!r}")
    reader = _Reader(step_dir, meta["files"], device, keep)
    try:
        out = reader.read(stored, like, "")
    finally:
        reader.close()
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, reader.nbytes


def _is_sharded(tensors: dict[str, torch.Tensor]) -> bool:
    """Whether a state holds DTensors (a sharded trainer's)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tensors.values())


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A leaf as its whole tensor: a DTensor's blocks gathered (every rank
    calls this), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    from kubeflow_tpu_torch.parallel.sharding import gather

    return gather(t.to_local(), t.device_mesh, t.placements)


# -- the manager --------------------------------------------------------------


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1):
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        #: seconds and bytes of the last save and restore
        self.last_save: dict[str, float] | None = None
        self.last_restore: dict[str, float] | None = None

    def all_steps(self) -> list[int]:
        """The committed steps on disk, ascending."""
        return _all_steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """orbax's decision: past the newest step, and on the interval or
        the first save of an empty directory."""
        steps = self.all_steps()
        if steps and steps[-1] >= step:
            return False
        return step % self.save_interval_steps == 0 or not steps

    def save(self, step: int, state: dict[str, Any], *,
             force: bool = False) -> bool:
        """Commit `state` as `step` when the rule (or `force`) says so;
        returns whether it saved. A step that exists is never
        overwritten. A sharded state is decided by rank 0 alone (its
        `force` and its view of its directory) for every rank."""
        t0 = time.perf_counter()
        tensors: dict[str, torch.Tensor] = {}
        tree = _flatten(state, (), tensors)
        if _is_sharded(tensors):
            return self._save_sharded(step, tree, tensors, force, t0)
        if not self._decide(step, force):
            return False
        # the host copy: after this the caller may change the state
        host = {n: t.detach().cpu() for n, t in tensors.items()}
        self._write(step, tree, host, t0)
        return True

    def _decide(self, step: int, force: bool) -> bool:
        """Whether `step` is saved; raises when it exists."""
        if not force and not self.should_save(step):
            return False
        if os.path.exists(os.path.join(self.directory, str(step))):
            raise ValueError(f"checkpoint for step {step} already exists "
                             f"under {self.directory}")
        return True

    def _save_sharded(self, step: int, tree, tensors: dict[str, Any],
                      force: bool, t0: float) -> bool:
        """Rank 0 decides and the others take its decision, so ranks that
        see other directories (node-local paths) run the same
        collectives; every rank gathers each leaf in turn and rank 0
        writes; rank 0's outcome is sent to the others, so a failed
        write raises on every rank instead of leaving them waiting."""
        import torch.distributed as dist

        primary = dist.get_rank() == 0
        decision: list[Any] = [None]
        if primary:
            try:
                decision[0] = self._decide(step, force)
            except ValueError as e:
                decision[0] = str(e)
        dist.broadcast_object_list(decision, src=0)
        if isinstance(decision[0], str):
            raise ValueError(decision[0])
        if not decision[0]:
            return False
        host = {}
        for n, t in tensors.items():
            whole = _whole(t)
            if primary:
                host[n] = whole.detach().cpu()
            del whole
        outcome: list[str | None] = [None]
        failed = None
        if primary:
            try:
                self._write(step, tree, host, t0)
            except Exception as e:
                failed = e
                outcome[0] = f"{type(e).__name__}: {e}"
        del host
        dist.broadcast_object_list(outcome, src=0)
        if failed is not None:
            raise failed
        if outcome[0] is not None:
            raise RuntimeError(f"checkpoint step {step}: rank 0's write "
                               f"failed: {outcome[0]}")
        if not primary:
            self.last_save = None
        return True

    def _write(self, step: int, tree, host: dict[str, torch.Tensor],
               t0: float) -> None:
        """Commit the host copy `host` as `step`: files, tree, rename,
        manifest, then the old steps go; sets last_save."""
        t1 = time.perf_counter()
        groups: dict[str, list[str]] = {}
        for n in host:
            groups.setdefault(n.split("/", 1)[0], []).append(n)
        shards = [s for g, names in groups.items()
                  for s in _shards(names, host, g)]
        files = {n: fname for fname, names in shards for n in names}
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.tmp-{os.getpid()}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        nbytes = 0
        with concurrent.futures.ThreadPoolExecutor(
                max(1, min(HASH_THREADS, len(shards)))) as pool:
            futs = [pool.submit(safetensors.save_file,
                                {n: host[n] for n in names},
                                os.path.join(tmp, fname))
                    for fname, names in shards]
            nbytes = sum(f.result() for f in futs)
        _atomic_write_json(os.path.join(tmp, TREE_NAME),
                           {"version": 1, "step": step, "tree": tree,
                            "files": files})
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        t2 = time.perf_counter()
        stats = {"step": step, "bytes": nbytes, "host_copy_s": t1 - t0,
                 "write_s": t2 - t1}
        try:
            write_step_manifest(self.directory, step, stats)
        except OSError:
            # a failed commit (disk error, injected fault) leaves the
            # step unmanifested: in a manifested tree that reads as
            # partial and is quarantined at restore, the honest outcome
            # of a commit that did not finish
            stats["manifest_failed"] = True
        self._remove_old()
        stats["total_s"] = time.perf_counter() - t0
        stats["write_gb_per_s"] = nbytes / 1e9 / max(stats["write_s"], 1e-9)
        self.last_save = stats

    def _remove_old(self) -> None:
        """orbax's LatestN: all but the newest max_to_keep steps go."""
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(s)))

    def latest_intact_step(self) -> int | None:
        """Newest step that passes manifest verification; corrupt and
        partial steps are quarantined on the way down (the restore-side
        half of the integrity contract)."""
        steps = sorted(self.all_steps(), reverse=True)
        # hash each step once: verify_step hashes the whole tree, and at
        # 8B scale a second pass doubles crash-recovery wall time
        statuses = {s: verify_step(self.directory, s) for s in steps}
        has_manifests = any(st not in ("unmanifested", "missing")
                            for st in statuses.values())
        for s in steps:
            status = statuses[s]
            if status == "intact":
                return s
            if status == "unmanifested" and not has_manifests:
                # a tree without manifests (foreign or older checkpoints):
                # trust the newest step
                return s
            if status == "missing":
                continue
            # corrupt, or partial in a manifested tree: out of the way
            quarantine_step(self.directory, s)
        return None

    def restore(self, state_like: dict[str, Any], step: int | None = None,
                *, device=None, keep=None) -> dict[str, Any]:
        """The state of `step` in the structure of `state_like` (tensors
        or meta tensors of the right shapes, dtypes and requires_grad;
        scalars are taken from the checkpoint). Tensors are allocated on
        `device`, or on the like tensor's device, and read into; with
        `keep(path, whole)`, each leaf is what keep makes of it (a
        sharded trainer's block) unless it returns None. With no explicit
        step, the newest intact step is used: a corrupt or partial newest
        step is quarantined and the restore falls back."""
        t0 = time.perf_counter()
        step = step if step is not None else self.latest_intact_step()
        t1 = time.perf_counter()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        step_dir = _step_dir(self.directory, step)
        if step_dir is None:
            raise FileNotFoundError(
                f"no checkpoint for step {step} under {self.directory}")
        out, nbytes = _read_step(step_dir, state_like, device, keep=keep)
        t2 = time.perf_counter()
        self.last_restore = {"step": step, "bytes": nbytes,
                             "verify_s": t1 - t0, "read_s": t2 - t1}
        return out

    def wait(self) -> None:
        """Saves are synchronous: nothing is pending."""

    def close(self) -> None:
        self.wait()


def restore_or_init(trainer, directory: str | None):
    """The resume contract: if a checkpoint exists, restore its newest
    intact step straight into tensors allocated from the state's shapes
    (`trainer.abstract_state()`) on the trainer's device, with no
    throwaway random init (at 8B scale an init is gigabytes of wasted
    work); else initialize fresh. On a mesh, rank 0 picks the step (and
    quarantines what it must) and every rank restores that step's blocks
    (`trainer.restore_leaf`). Returns (state, resumed)."""
    if directory:
        mngr = CheckpointManager(directory)
        sharded = getattr(trainer, "layout", None) is not None
        if sharded:
            import torch.distributed as dist

            pick = [mngr.latest_intact_step() if dist.get_rank() == 0
                    else None]
            dist.broadcast_object_list(pick, src=0)
            step = pick[0]
        else:
            step = mngr.latest_intact_step()
        if step is not None:
            state = mngr.restore(
                trainer.abstract_state(), step=step, device=trainer.device,
                keep=trainer.restore_leaf if sharded else None)
            mngr.close()
            return state, True
        mngr.close()
    return trainer.init_state(), False


def restore_params(directory: str, abstract_params, *,
                   step: int | None = None, device="cpu",
                   subtree: str = "params"):
    """Only the `params` subtree of a trainer checkpoint (the serving
    side's restore: no optimizer state), read into tensors of
    `abstract_params`' shapes and dtypes on `device`; `subtree`
    "params/lora" reads a llama_lora checkpoint's adapters alone. With
    no step, the newest one (`latest_step`, as the JAX function takes
    it). Raises FileNotFoundError when the directory holds no
    checkpoint: a configured but empty checkpoint must never serve
    random weights."""
    directory = os.path.abspath(directory)
    if step is None:
        steps = _all_steps(directory)
        step = steps[-1] if steps else None
    step_dir = _step_dir(directory, step) if step is not None else None
    if step_dir is None:
        raise FileNotFoundError(f"no checkpoint under {directory!r}")
    out, _ = _read_step(step_dir, abstract_params, device, subtree=subtree)
    return out

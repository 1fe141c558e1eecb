"""The model storage initializer (the port's copy of kubeflow_tpu/
serving/storage.py): `download(uri)` resolves a storage URI to a local
path through a registry of fetchers per scheme.

    file:///path or a bare path   the path itself (copied if copy=True)
    ktpu://<digest>               an object of a pipelines artifact store
                                  (artifact_root or KTPU_ARTIFACT_ROOT)
    pvc://<volume>/<subpath>      a platform Volume's managed directory
                                  under the namespace
    hf://<org>/<name>[@rev]       a snapshot in the LOCAL HuggingFace hub
                                  cache (HF_HUB_CACHE / HF_HOME); no network
    gs://, s3://, http(s)://      recognized, raising: they need a network

The JAX module takes two path rules from other JAX modules; the port
keeps its own copies of just those rules: an artifact's object path
(`pipelines/artifacts.py` `ArtifactStore`) and the volumes root and a
volume's directory (`platform/volumes.py` `default_volumes_root`,
`volume_path`).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Callable

log = logging.getLogger(__name__)

#: the pipelines artifact URI scheme
ARTIFACT_SCHEME = "ktpu://"


class StorageError(Exception):
    pass


def default_volumes_root() -> str:
    """Where platform Volumes live: KTPU_VOLUMES_ROOT, else
    $TMPDIR/kubeflow-tpu-volumes (the JAX volumes controller's rule)."""
    return os.environ.get("KTPU_VOLUMES_ROOT") or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "kubeflow-tpu-volumes")


def volume_path(root: str, ns: str, name: str) -> str:
    return os.path.join(root, ns, name)


def artifact_path(root: str, uri: str) -> str:
    """The object file of a `ktpu://<digest>` artifact under an artifact
    store's root (the store makes its objects directory, as the JAX
    `ArtifactStore` does); FileNotFoundError when it is not there."""
    if not uri.startswith(ARTIFACT_SCHEME):
        raise ValueError(f"not a {ARTIFACT_SCHEME} uri: {uri}")
    os.makedirs(os.path.join(root, "objects"), exist_ok=True)
    digest = uri[len(ARTIFACT_SCHEME):]
    path = os.path.join(root, "objects", digest[:2], digest)
    if not os.path.exists(path):
        raise FileNotFoundError(uri)
    return path


class StorageContext:
    """What fetchers may need beyond the URI itself."""

    def __init__(self, artifact_root: str | None = None,
                 namespace: str | None = None,
                 volumes_root: str | None = None):
        self.artifact_root = artifact_root or os.environ.get(
            "KTPU_ARTIFACT_ROOT")
        self.namespace = namespace or os.environ.get("KTPU_NAMESPACE",
                                                     "default")
        self.volumes_root = volumes_root or default_volumes_root()


Fetcher = Callable[[str, StorageContext], str]
_FETCHERS: dict[str, Fetcher] = {}


def register_fetcher(scheme: str):
    """Install `fn(rest_of_uri, ctx) -> local_path` for `scheme://` URIs;
    a re-registration replaces."""

    def deco(fn: Fetcher) -> Fetcher:
        _FETCHERS[scheme] = fn
        return fn

    return deco


def registered_schemes() -> list[str]:
    return sorted(_FETCHERS)


@register_fetcher("ktpu")
def _fetch_artifact(rest: str, ctx: StorageContext) -> str:
    if not ctx.artifact_root:
        raise StorageError(
            "ktpu:// uri needs artifact_root (or KTPU_ARTIFACT_ROOT)")
    return artifact_path(ctx.artifact_root, ARTIFACT_SCHEME + rest)


@register_fetcher("file")
def _fetch_file(rest: str, ctx: StorageContext) -> str:
    # file:///abs -> /abs; file://rel/path stays relative (cwd-resolved)
    return rest


@register_fetcher("pvc")
def _fetch_pvc(rest: str, ctx: StorageContext) -> str:
    vol, _, sub = rest.partition("/")
    if not vol:
        raise StorageError("pvc:// uri needs a volume name: pvc://<vol>/<path>")
    root = volume_path(ctx.volumes_root, ctx.namespace, vol)
    if not os.path.isdir(root):
        raise StorageError(
            f"volume {vol!r} is not bound in namespace {ctx.namespace!r} "
            f"(no {root}); create the Volume resource first")
    path = os.path.normpath(os.path.join(root, sub))
    if not (path == root or path.startswith(root + os.sep)):
        raise StorageError(f"pvc path escapes the volume: {rest!r}")
    return path


@register_fetcher("hf")
def _fetch_hf(rest: str, ctx: StorageContext) -> str:
    """hf://org/name[@rev] -> a snapshot directory of the local hub cache:
    refs/<rev> (default main) names the snapshot; a pinned revision must
    resolve exactly; without a ref the newest snapshot by mtime, with a
    warning naming it when there are several."""
    repo, _, rev = rest.partition("@")
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")),
        "hub")
    model_root = os.path.join(hub, "models--" + repo.replace("/", "--"))
    snap_root = os.path.join(model_root, "snapshots")
    ref_file = os.path.join(model_root, "refs", rev or "main")
    if os.path.isfile(ref_file):
        with open(ref_file) as f:
            snap = os.path.join(snap_root, f.read().strip())
        if os.path.isdir(snap):
            return snap
    if rev:
        direct = os.path.join(snap_root, rev)
        if os.path.isdir(direct):
            return direct
        raise StorageError(
            f"hf://{repo}@{rev} is not in the local HuggingFace cache "
            f"({hub}); pre-download that revision or drop the pin")
    snaps = (sorted((os.path.join(snap_root, s) for s in
                     os.listdir(snap_root)), key=os.path.getmtime)
             if os.path.isdir(snap_root) else [])
    if not snaps:
        raise StorageError(
            f"hf://{repo} is not in the local HuggingFace cache ({hub}) and "
            "this environment has no network; pre-download the model or "
            "point storageUri at it with file://")
    if len(snaps) > 1:
        log.warning(
            "hf://%s has no ref for %r; %d cached snapshots, serving newest "
            "by mtime: %s — pin a revision (hf://%s@<rev>) to be exact",
            repo, rev or "main", len(snaps), os.path.basename(snaps[-1]),
            repo)
    return snaps[-1]


def _offline(scheme: str) -> Fetcher:
    def fetch(rest: str, ctx: StorageContext) -> str:
        raise StorageError(
            f"{scheme}://{rest} requires network access, unavailable here; "
            f"mount the model locally and use file://, or "
            f"register_fetcher({scheme!r}) with a cloud SDK hook")

    return fetch


for _s in ("gs", "s3", "https", "http"):
    register_fetcher(_s)(_offline(_s))


def download(uri: str, dest_dir: str | None = None, *,
             artifact_root: str | None = None, copy: bool = False,
             namespace: str | None = None) -> str:
    """Resolve `uri` to a local filesystem path (the /mnt/models analog)."""
    ctx = StorageContext(artifact_root=artifact_root, namespace=namespace)
    scheme, sep, rest = uri.partition("://")
    if sep:
        fetcher = _FETCHERS.get(scheme)
        if fetcher is None:
            raise StorageError(
                f"unknown storage scheme {scheme!r} (registered: "
                f"{', '.join(registered_schemes())})")
        path = fetcher(rest, ctx)
    else:
        path = uri  # bare local path
    if not os.path.exists(path):
        raise StorageError(f"model path does not exist: {path}")
    if not copy or dest_dir is None:
        return path
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, os.path.basename(path.rstrip("/")))
    if os.path.isdir(path):
        shutil.copytree(path, dest, dirs_exist_ok=True)
    else:
        shutil.copyfile(path, dest)
    return dest

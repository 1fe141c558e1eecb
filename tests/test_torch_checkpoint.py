"""The port's checkpoints (training/checkpoint.py over its safetensors
writer) against the JAX manager: the seven cases of
tests/test_checkpoint_integrity.py on the port's manager (manifests,
quarantine and fallback, the chaos seams), a bit-exact restore of the
trainer's state with a bf16 first moment, the set of step directories
equal to the JAX orbax manager's for one sequence of saves, the writer
read back by the port's reader and by the `safetensors` package, and
`restore_params` / `abstract_state`."""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.training.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from kubeflow_tpu_torch.chaos import (FaultInjector, FaultScriptConfig,
                                      FaultSpec, generate_fault_script,
                                      set_io_fault_hook)
from kubeflow_tpu_torch.models import safetensors as tst
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.checkpoint import (MANIFEST_NAME,
                                                    QUARANTINE_DIR,
                                                    CheckpointManager,
                                                    quarantine_step,
                                                    restore_or_init,
                                                    restore_params,
                                                    verify_step,
                                                    write_step_manifest)
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

torch.set_num_threads(2)


@pytest.fixture
def io_hook():
    """Arm a chaos I/O fault hook for the test; always restore after."""
    prev = set_io_fault_hook(None)

    def arm(fn):
        set_io_fault_hook(fn)

    yield arm
    set_io_fault_hook(prev)


def _state(s: int) -> dict:
    return {"step": s, "params": {"w": torch.arange(64.0) * s}}


def _save_steps(d: str, steps) -> CheckpointManager:
    m = CheckpointManager(d, max_to_keep=8)
    for s in steps:
        assert m.save(s, _state(s))
    m.wait()
    return m


def _some_data_file(step_dir: str) -> str:
    for root, _dirs, files in os.walk(step_dir):
        for f in sorted(files):
            p = os.path.join(root, f)
            if f != MANIFEST_NAME and os.path.getsize(p) > 8:
                return p
    raise AssertionError(f"no data file under {step_dir}")


def test_manifests_written_and_steps_intact(tmp_path):
    d = str(tmp_path)
    m = _save_steps(d, (1, 2, 3))
    for s in (1, 2, 3):
        assert verify_step(d, s) == "intact"
        with open(os.path.join(d, str(s), MANIFEST_NAME)) as f:
            manifest = json.load(f)
        assert manifest["step"] == s and manifest["files"]
    assert m.latest_intact_step() == 3
    m.close()


def test_truncation_mid_write_quarantines_and_falls_back(tmp_path, io_hook):
    d = str(tmp_path)
    m = _save_steps(d, (1, 2))

    def truncate_at_commit(op: str, path: str) -> None:
        if op == "checkpoint_commit" and os.path.basename(path) == "3":
            victim = _some_data_file(path)
            with open(victim, "r+b") as f:
                f.truncate(os.path.getsize(victim) // 2)

    io_hook(truncate_at_commit)
    assert m.save(3, _state(3))
    m.wait()
    assert verify_step(d, 3) == "corrupt"
    assert m.latest_intact_step() == 2
    assert os.path.isdir(os.path.join(d, QUARANTINE_DIR, "3"))
    assert not os.path.isdir(os.path.join(d, "3"))
    restored = m.restore(_state(0))
    assert restored["step"] == 2
    assert torch.equal(restored["params"]["w"], torch.arange(64.0) * 2)
    m.close()


def test_crash_before_manifest_reads_as_partial(tmp_path, io_hook):
    d = str(tmp_path)
    m = _save_steps(d, (1, 2))

    def die_at_manifest(op: str, path: str) -> None:
        if op == "manifest_write" \
                and os.path.basename(os.path.dirname(path)) == "3":
            raise OSError("injected: crash before manifest commit")

    io_hook(die_at_manifest)
    assert m.save(3, _state(3))
    m.wait()
    assert verify_step(d, 3) == "unmanifested"
    assert m.latest_intact_step() == 2
    assert os.path.isdir(os.path.join(d, QUARANTINE_DIR, "3"))
    m.close()


def test_legacy_tree_without_manifests_still_restores(tmp_path):
    d = str(tmp_path)
    m = _save_steps(d, (1, 2))
    for s in (1, 2):
        os.remove(os.path.join(d, str(s), MANIFEST_NAME))
    assert verify_step(d, 2) == "unmanifested"
    assert m.latest_intact_step() == 2
    assert m.restore(_state(0))["step"] == 2
    m.close()


def test_restore_or_init_skips_corrupt_newest(tmp_path):
    d = str(tmp_path)
    m = _save_steps(d, (1, 2, 3))
    m.close()
    victim = _some_data_file(os.path.join(d, "3"))
    with open(victim, "r+b") as f:
        f.truncate(max(1, os.path.getsize(victim) // 3))
    m2 = CheckpointManager(d)
    assert m2.latest_intact_step() == 2
    m2.close()


def test_manifest_helpers_on_missing_step(tmp_path):
    d = str(tmp_path)
    assert verify_step(d, 9) == "missing"
    assert not write_step_manifest(d, 9)
    assert quarantine_step(d, 9) is None


def test_scripted_ckpt_io_fail_bridges_to_commit_seam(tmp_path, io_hook):
    d = str(tmp_path)
    m = _save_steps(d, (1, 2))
    script = generate_fault_script(FaultScriptConfig(
        seed=13, duration_s=1.0,
        faults=(FaultSpec("ckpt_io_fail", 1, (0.0, 0.0)),)), name="io")
    inj = FaultInjector(script)
    inj.start()
    io_hook(inj.as_io_fault_hook())
    assert m.save(3, _state(3))
    m.wait()
    assert [f["kind"] for f in inj.log()] == ["ckpt_io_fail"]
    assert verify_step(d, 3) == "corrupt"
    assert m.latest_intact_step() == 2
    assert m.save(4, _state(4))   # one-shot: the next save is clean
    m.wait()
    assert verify_step(d, 4) == "intact"
    m.close()


TINY = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=64, max_seq_len=32, dtype="float32")


def _trainer(ckpt_dir=None, every=1):
    cfg = ttrainer.TrainerConfig(
        model="llama", model_overrides=TINY, batch_size=2, log_every=1,
        optimizer=ttrainer.OptimizerConfig(learning_rate=1e-2,
                                           warmup_steps=1, total_steps=10,
                                           mu_dtype="bfloat16"),
        checkpoint_dir=ckpt_dir, checkpoint_every=every, keep_checkpoints=2)
    return ttrainer.Trainer(cfg, device="cpu",
                            metrics=MetricsWriter(echo=False))


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.detach(), b.detach())
    else:
        assert a == b


def test_restore_is_bit_exact_with_a_bf16_mu(tmp_path):
    """The trainer's state after 3 steps (f32 params and nu, bf16 mu, the
    count and the step) restores bit for bit through restore_or_init
    into tensors allocated from abstract_state, on a trainer of its own;
    its params train on."""
    d = str(tmp_path / "ckpt")
    tr = _trainer(d)
    data = tdata.synthetic_tokens(2, 16, 128, seed=1)
    state = tr.train(data, 3)
    assert state["opt_state"]["mu"][0].dtype == torch.bfloat16
    assert sorted(os.listdir(d)) == ["2", "3"]
    tr2 = _trainer(d)
    got, resumed = restore_or_init(tr2, d)
    assert resumed and got["step"] == 3 and got["opt_state"]["count"] == 3
    _same_tree(got, state)
    assert all(p.requires_grad for p in ttrainer.leaves(got["params"]))
    assert not any(t.requires_grad for t in got["opt_state"]["mu"])
    tr2.train(data, 1, got)
    assert got["step"] == 4
    fresh, resumed = restore_or_init(_trainer(), None)
    assert not resumed and fresh["step"] == 0


def test_abstract_state_has_init_shapes_and_dtypes():
    tr = _trainer()
    abstract, real = tr.abstract_state(), tr.init_state()
    assert all(t.device.type == "meta"
               for t in ttrainer.leaves(abstract["params"]))
    a = ttrainer.leaves(abstract["params"]) + abstract["opt_state"]["mu"] \
        + abstract["opt_state"]["nu"]
    r = ttrainer.leaves(real["params"]) + real["opt_state"]["mu"] \
        + real["opt_state"]["nu"]
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in r]
    assert abstract["step"] == real["step"] == 0


def _step_dirs(d):
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


def test_step_set_equals_the_jax_orbax_managers(tmp_path):
    """One sequence of saves (orbax's initial save, the interval, an old
    step refused, a forced save, max_to_keep, and a second manager on the
    same directory, as a resumed job has) leaves the same step
    directories, save by save, under the port's manager and JAX's."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    seq = [(1, False), (2, False), (3, False), (4, False), (3, False),
           (5, True), (6, False), (7, False)]
    for phase, steps in enumerate((seq, [(8, False), (9, False),
                                         (10, False), (11, True)])):
        jm = JaxCheckpointManager(jd, max_to_keep=3, save_interval_steps=2)
        tm = CheckpointManager(td, max_to_keep=3, save_interval_steps=2)
        for step, force in steps:
            j_saved = jm.save(step, {"step": step,
                                     "w": jnp.full((4,), float(step))},
                              force=force)
            jm.wait()
            t_saved = tm.save(step, {"step": step,
                                     "w": torch.full((4,), float(step))},
                              force=force)
            assert (t_saved, _step_dirs(td)) == (j_saved, _step_dirs(jd)), (
                phase, step)
            assert tm.latest_step() == jm.latest_step()
        jm.close()
        tm.close()
    assert _step_dirs(td) == [8, 10, 11]


def test_restore_params_reads_the_newest_params(tmp_path):
    d = str(tmp_path / "ckpt")
    tr = _trainer(d, every=2)
    state = tr.train(tdata.synthetic_tokens(2, 16, 128, seed=2), 3)
    assert sorted(os.listdir(d)) == ["2", "3"]
    params = restore_params(d, tr.model.abstract(tr.model_cfg))
    _same_tree(params, state["params"])
    two = restore_params(d, tr.model.abstract(tr.model_cfg), step=2)
    assert not torch.equal(two["embed"], params["embed"])
    os.makedirs(tmp_path / "empty")
    for empty in (tmp_path / "empty", tmp_path / "missing"):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            restore_params(str(empty), tr.model.abstract(tr.model_cfg))
    with pytest.raises(ValueError, match="state wants"):
        restore_params(d, tr.model.abstract(
            tr.model.config_cls(**dict(TINY, d_model=64))))


def test_writer_read_back_by_the_reader_and_the_package(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5), np.float32)),
        "bf16": torch.from_numpy(
            rng.standard_normal(7, np.float32)).bfloat16(),
        "f16": torch.from_numpy(rng.standard_normal(2, np.float32)).half(),
        "i8": torch.arange(-4, 2, dtype=torch.int8).reshape(2, 3),
        "i32": torch.tensor(3, dtype=torch.int32),
        "i64": torch.tensor(2 ** 40, dtype=torch.int64),
        "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "a.safetensors")
    size = tst.save_file(tensors, path)
    assert size == os.path.getsize(path)
    with tst.SafeFile(path) as f:
        assert sorted(f.keys()) == sorted(tensors)
        assert f.metadata() is None
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and torch.equal(got, t)
    ref = st.load_file(path)
    for k, t in tensors.items():
        assert ref[k].dtype == t.dtype and torch.equal(ref[k], t)
    with pytest.raises(tst.SafetensorsError, match="dtype"):
        tst.save_file({"c": torch.zeros(2, dtype=torch.complex64)}, path)

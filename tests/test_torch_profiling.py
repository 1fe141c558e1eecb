"""The port's profiling module (training/profiling.py) on the CPU, mirroring
tests/test_decode_breakdown.py: serving_decode_breakdown's dict has the JAX
breakdown's keys, its device buckets partition the measured step, its
probes are None or numbers where the JAX breakdown's are, it clamps on a
small cache, records the analytic floor and a trace, leaves the engine
serving the same greedy tokens, and reads the engine's perf counters;
StepProfiler and trace write their markers and trace files; the Trainer's
profile window; and the build stamp. The numbers are CPU toy numbers:
what is held is the contract, not a time."""

import json
import os

import pytest
import torch

from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.obs import build as tbuild
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.training import profiling as tprof
from kubeflow_tpu_torch.training import trainer as ttrainer
from kubeflow_tpu_torch.training.data import synthetic_tokens
from kubeflow_tpu_torch.training.metrics_writer import MetricsWriter

torch.set_num_threads(2)

# the JAX breakdown's keys (kubeflow_tpu/training/profiling.py, the dict it
# returns; "pipeline" only for stage-sharded engines, which the port lacks)
JAX_KEYS = {"steps", "span", "n_slots", "fill_len", "iters",
            "chunk_wall_ms", "device_step_ms", "dispatch_rtt_ms",
            "weight_read_bytes", "weight_read_gbps", "buckets_ms",
            "host_dispatch_per_step_ms", "perf_counters"}
JAX_BUCKETS = {"weight_read", "attention_kv_update", "attn_kernel",
               "attn_dequant", "prefill_attn", "sampling_penalties",
               "dispatch_rtt_per_step", "host_fetch_replay_per_step",
               "kv_handoff", "kv_gather", "pipeline_bubble"}
# the JAX engine's perf_counters keys (kubeflow_tpu/serving/llm.py)
JAX_PERF = {"dispatch_s", "fetch_replay_s", "decode_chunks", "decode_steps",
            "active_uploads"}
PROMPT = [1, 2, 3]


def _partition(bd):
    b = bd["buckets_ms"]
    return b["weight_read"] + b["attention_kv_update"] + \
        b["sampling_penalties"]


@pytest.fixture(scope="module")
def params():
    cfg = tllama.LlamaConfig.tiny()
    return cfg, tllama.init(cfg, seed=0, device="cpu")


@pytest.fixture(scope="module")
def engine(params):
    cfg, p = params
    return LLMEngine(p, cfg, n_slots=2, max_len=64, buckets=(16,),
                     decode_chunk=4, device="cpu")


def test_breakdown_has_the_jax_keys_and_partitions_the_step(engine):
    engine.perf_counters(reset=True)
    before = engine.generate(PROMPT, 8)   # fills the host counters
    bd = tprof.serving_decode_breakdown(engine, steps=2, iters=3)
    assert set(bd) == JAX_KEYS
    assert set(bd["buckets_ms"]) == JAX_BUCKETS
    assert set(bd["perf_counters"]) == JAX_PERF
    b = bd["buckets_ms"]
    for name, val in b.items():
        assert val is None or val >= 0, (name, b)
    assert _partition(bd) == pytest.approx(bd["device_step_ms"], rel=0.02)
    assert b["host_fetch_replay_per_step"] is not None
    assert bd["host_dispatch_per_step_ms"] is not None
    assert bd["weight_read_bytes"] > 0
    # no prefix cache, no stage-sharded engine, slab reads are contiguous
    assert b["kv_handoff"] is None and b["pipeline_bubble"] is None
    assert b["kv_gather"] is None
    assert b["attn_dequant"] == 0.0   # bf16 cache: nothing to dequantize
    assert b["attn_kernel"] >= 0 and b["prefill_attn"] >= 0
    # profiling resets the slot state: the engine serves the same tokens
    assert engine.generate(PROMPT, 8) == before


def test_partition_holds_when_the_stripped_chunk_times_slower(
        engine, monkeypatch):
    """A stripped chunk timed slower than the full one (noise) leaves the
    sampling bucket 0, and the buckets still sum to the device step."""
    real = tprof._median_times

    def noisy(runs, iters):
        out = real(runs, iters)
        if len(runs) == 2:   # (full, stripped) on the slab engine
            out[1] = out[0] * 1.5
        return out

    monkeypatch.setattr(tprof, "_median_times", noisy)
    bd = tprof.serving_decode_breakdown(engine, steps=2, iters=2)
    b = bd["buckets_ms"]
    assert b["sampling_penalties"] == 0.0
    assert _partition(bd) == pytest.approx(bd["device_step_ms"], rel=1e-3)


def test_perf_counters_count_decode_chunks_and_steps(engine):
    engine.perf_counters(reset=True)
    engine.generate(PROMPT, 9)   # prefill gives 1 token, decode 8
    perf = engine.perf_counters(reset=True)
    assert perf["decode_steps"] == 8 and perf["decode_chunks"] == 2
    assert perf["dispatch_s"] > 0 and perf["fetch_replay_s"] > 0
    # the mask is uploaded when it changes, not every chunk
    assert perf["active_uploads"] <= 1
    assert engine.perf_counters() == {k: 0 for k in JAX_PERF}
    rids = [engine.submit(PROMPT, 3), engine.submit(PROMPT[:2], 3)]
    engine.run_until_idle()
    assert all(engine.is_done(r) for r in rids)
    perf = engine.perf_counters(reset=True)
    assert perf["active_uploads"] >= 1 and perf["decode_steps"] == 2


def test_decode_chunk_variants_agree_on_greedy_rows(engine):
    """sample=True runs the sampling path; at temperature 0 it picks the
    argmax that sample=False takes (column 0 of the packed rows)."""
    active = torch.ones(engine.n_slots, dtype=torch.bool)
    toks = []
    for sample in (True, False):
        engine.lengths.fill_(5)
        engine.last_tokens.fill_(1)
        out = engine._decode_chunk(2, 128, active, sample=sample)
        toks.append(out[..., 0])
    assert toks[0].shape == (2, engine.n_slots)
    assert torch.equal(toks[0], toks[1])
    engine.lengths.zero_()
    engine.last_tokens.zero_()


def test_attn_dequant_measured_on_int8_cache(params):
    cfg, p = params
    eng = LLMEngine(p, cfg, n_slots=2, max_len=32, buckets=(8,),
                    decode_chunk=2, kv_quantize="int8", device="cpu")
    bd = tprof.serving_decode_breakdown(eng, steps=1, iters=2)
    b = bd["buckets_ms"]
    assert isinstance(b["attn_dequant"], float) and b["attn_dequant"] >= 0
    assert b["attn_kernel"] >= 0 and b["prefill_attn"] >= 0


def test_paged_breakdown_reads_through_the_tables(params, monkeypatch):
    """kv_gather is a number, and both attention probes go through the
    slot tables (K2-paged and K3-paged on the card)."""
    cfg, p = params
    eng = PagedLLMEngine(p, cfg, n_slots=2, max_len=32, buckets=(8,),
                         decode_chunk=2, kv_quantize="int8", device="cpu")
    before = eng.generate(PROMPT, 6)
    seen = []
    for name in ("prefill_attention", "decode_attention"):
        def spy(*a, _f=getattr(tllama, name), _n=name, **kw):
            seen.append((_n, kw.get("tables", a[-1] if _n ==
                                    "decode_attention" else None)))
            return _f(*a, **kw)
        monkeypatch.setattr(tllama, name, spy)
    bd = tprof.serving_decode_breakdown(eng, steps=1, iters=2)
    monkeypatch.undo()
    b = bd["buckets_ms"]
    assert isinstance(b["kv_gather"], float) and b["kv_gather"] >= 0
    assert b["attn_kernel"] >= 0 and b["attn_dequant"] >= 0
    assert b["prefill_attn"] >= 0
    assert b["kv_handoff"] is None and b["pipeline_bubble"] is None
    probes = {n for n, tbl in seen if tbl is not None
              and tbl.dtype == torch.int32 and tbl.shape == (2, 4)}
    assert probes == {"prefill_attention", "decode_attention"}
    assert eng.generate(PROMPT, 6) == before


def test_breakdown_clamps_steps_on_small_cache(params):
    cfg, p = params
    eng = LLMEngine(p, cfg, n_slots=2, max_len=32, buckets=(8,),
                    decode_chunk=16, device="cpu")
    bd = tprof.serving_decode_breakdown(eng, iters=2)
    assert bd["steps"] < 16
    assert (2 * bd["iters"] + 4) * bd["steps"] + 2 <= 32
    assert bd["buckets_ms"]["weight_read"] >= 0


def test_breakdown_records_analytic_floor_when_bandwidth_given(engine):
    bd = tprof.serving_decode_breakdown(engine, steps=1, iters=2,
                                        hbm_gbps=100.0)
    assert bd["weight_read_floor_ms"] > 0
    assert bd["weight_read_frac_of_peak"] > 0


def test_breakdown_trace_dir_gives_a_trace(engine, tmp_path):
    trace_dir = str(tmp_path / "decode_trace")
    bd = tprof.serving_decode_breakdown(engine, steps=1, iters=2,
                                        trace_dir=trace_dir)
    assert bd["trace_dir"] == trace_dir and "trace_error" not in bd
    assert os.path.exists(os.path.join(trace_dir, "PROFILE_DONE"))
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(trace_dir))


def test_breakdown_trace_dir_failure_is_recorded(engine, tmp_path):
    """A trace that cannot be written is an error in the dict, never a
    failed breakdown."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    bd = tprof.serving_decode_breakdown(engine, steps=1, iters=2,
                                        trace_dir=str(blocker / "t"))
    assert "trace_error" in bd and "trace_dir" not in bd
    assert set(bd) - {"trace_error"} == JAX_KEYS


def _traces(d):
    return [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]


def test_step_profiler_and_trace_write_marker_and_trace(tmp_path):
    x = torch.randn(32, 32)
    prof = tprof.StepProfiler(str(tmp_path / "win"), start_step=2,
                              num_steps=2)
    fences = []
    for step in range(1, 6):
        prof.maybe_start(step)
        assert prof.active == (2 <= step <= 3)
        x = x @ x.T / 32
        prof.maybe_stop(step, sync=lambda: fences.append(step))
    prof.close()
    assert prof.done and fences == [3]
    with open(tmp_path / "win" / "PROFILE_DONE") as f:
        assert f.read() == "steps 2..3\n"
    assert len(_traces(tmp_path / "win")) == 1
    with pytest.raises(ValueError):
        tprof.StepProfiler(str(tmp_path / "bad"), num_steps=0)
    with tprof.trace(str(tmp_path / "ctx")) as d:
        (x + 1).sum()
    assert d == str(tmp_path / "ctx") and len(_traces(d)) == 1


def test_trainer_profile_window(tmp_path):
    keys = dict(profile_dir=str(tmp_path / "prof"), profile_start_step=2,
                profile_num_steps=2)
    cfg = ttrainer.TrainerConfig.from_dict(dict(
        model="llama", model_overrides=dict(
            vocab_size=512, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=64, dtype="float32"),
        batch_size=2, log_every=1, num_steps=4, **keys))
    for k, v in keys.items():
        assert getattr(cfg, k) == v
    trainer = ttrainer.Trainer(cfg, device="cpu",
                               metrics=MetricsWriter(echo=False))
    state = trainer.train(synthetic_tokens(2, 32, 512, 0), 4)
    assert state["step"] == 4
    with open(tmp_path / "prof" / "PROFILE_DONE") as f:
        assert f.read() == "steps 2..3\n"
    assert len(_traces(tmp_path / "prof")) == 1
    # a resumed run opens its window relative to its own first step
    cfg.profile_dir = str(tmp_path / "resumed")
    trainer.train(synthetic_tokens(2, 32, 512, 1), 4, state)
    with open(tmp_path / "resumed" / "PROFILE_DONE") as f:
        assert f.read() == "steps 6..7\n"


def test_build_stamp_never_raises(monkeypatch):
    monkeypatch.setattr(tbuild, "_STAMP", None)
    stamp = tbuild.build_stamp()
    assert stamp["kubeflow_tpu_torch"] and stamp["torch"] == torch.__version__
    assert stamp["platform"] in ("cpu", "gpu")
    assert json.loads(json.dumps(stamp)) == stamp

    def broken():
        raise RuntimeError("no runtime")

    monkeypatch.setattr(tbuild, "_STAMP", None)
    monkeypatch.setattr(tbuild, "runtime_stamp", broken)
    stamp = tbuild.build_stamp()
    assert stamp["runtime_error"] == "RuntimeError: no runtime"
    assert tbuild.build_stamp() == stamp   # cached

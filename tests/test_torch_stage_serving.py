"""The port's stage-sharded engine (kubeflow_tpu_torch/serving/multichip.py)
on the CPU, mirroring tests/test_multichip_serving.py and
tests/test_stage_overlap.py on their tiny f32 config: against the port's
single-program `LLMEngine` bit for bit (greedy, seeded and penalized
tokens, logprobs and top-2 logprobs) at stage 1, at stage 2 under both
schedules, at an uneven stage 2 (3 layers, 3 slots), at stage 4 with
more stages than the wave is wide, and with int8 KV, the prefix cache
and chunked prefill; its greedy tokens against the JAX
`StageShardedEngine` (stage 2 on two of the 8 virtual CPU devices) on
weights carried by `models/interop.py`; the refusals; the bubble
accounting and the serving profiler's `pipeline_bubble`; mesh_info,
metrics and the per-stage spans; `LLMModel(parallel={"stage": 2})`
through the supervisor's factory, and its refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving.multichip import StageShardedEngine as JaxStaged
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama
from kubeflow_tpu_torch.obs.trace import TRACER
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
from kubeflow_tpu_torch.serving.multichip import StageShardedEngine
from kubeflow_tpu_torch.training.profiling import serving_decode_breakdown

torch.set_num_threads(2)

# the JAX tests' CFG and KW, f32 (the port's attention is its kernels'
# plain versions)
CFG = llama.LlamaConfig(vocab_size=256, d_model=64, n_layers=4, n_heads=8,
                        n_kv_heads=4, d_ff=128, max_seq_len=64, remat=False,
                        dtype=torch.float32)
KW = dict(n_slots=2, max_len=48, buckets=(8,), decode_chunk=4,
          logprobs_topk=2, device="cpu")
PROMPT = [5, 9, 2, 44, 17]


@pytest.fixture(scope="module")
def params():
    return llama.init(CFG, seed=7, device="cpu")


def _script(eng, prompts=(PROMPT, [7, 7, 3])):
    """Concurrent greedy rows, then a seeded row beside a penalized one:
    each request's tokens, logprobs and top-2 logprobs."""
    out = []
    for batch in ([dict(prompt=p, max_new_tokens=12) for p in prompts],
                  [dict(prompt=PROMPT, max_new_tokens=10, temperature=0.9,
                        top_k=8, seed=123),
                   dict(prompt=prompts[-1], max_new_tokens=9,
                        presence_penalty=0.5, frequency_penalty=0.3)]):
        rids = [eng.submit(**kw) for kw in batch]
        eng.run_until_idle()
        for r in rids:
            out.append((eng.result(r), eng.result_logprobs(r),
                        eng.result_top_logprobs(r)))
            eng.release(r)
    return out


@pytest.fixture(scope="module")
def reference(params):
    eng = LLMEngine(params, CFG, **KW)
    out = _script(eng)
    eng.close()
    return out


def test_stage1_bit_equal_single_program(params, reference):
    eng = StageShardedEngine(params, CFG, stage=1, **KW)
    assert _script(eng) == reference
    assert eng.mesh_info()["microbatches"] == [[0, 2]]
    eng.close()


@pytest.mark.parametrize("schedule", ["sync", "overlapped"])
def test_stage2_bit_equal_single_program(params, reference, schedule):
    eng = StageShardedEngine(params, CFG, stage=2, stage_schedule=schedule,
                             **KW)
    assert eng.stage_schedule == schedule
    assert _script(eng) == reference
    info = eng.mesh_info()
    assert info["layout"] == "tp1xpp2" and info["virtual_stages"]
    assert info["stage_layers"] == [2, 2]
    assert info["microbatches"] == [[0, 1], [1, 1]]
    assert info["params_bytes"] == sum(info["per_stage_params_bytes"])
    # the slabs are views on the caller's stacked weights
    assert (eng.params[1]["layers"]["wq"].untyped_storage().data_ptr()
            == params["layers"]["wq"].untyped_storage().data_ptr())
    assert eng.pipeline_perf()["schedule"] == schedule
    eng.close()


def test_uneven_layer_and_microbatch_split():
    """3 layers over 2 stages ([2, 1]) and 3 slots over 2 microbatches
    ([2, 1]), three concurrent requests."""
    cfg = dataclasses.replace(CFG, n_layers=3)
    p3 = llama.init(cfg, seed=3, device="cpu")
    kw = dict(KW, n_slots=3)
    prompts = (PROMPT, [7, 7, 3], [1, 2, 3, 4, 5, 6, 7])
    single = LLMEngine(p3, cfg, **kw)
    want = _script(single, prompts)
    single.close()
    eng = StageShardedEngine(p3, cfg, stage=2, **kw)
    assert eng.mesh_info()["stage_layers"] == [2, 1]
    assert eng.mesh_info()["microbatches"] == [[0, 2], [2, 1]]
    assert _script(eng, prompts) == want
    eng.close()


def test_stage_count_exceeds_wave_width(params, reference):
    """Four stages over two slots: one slot a microbatch, and a bubble of
    3/5 by the schedule."""
    eng = StageShardedEngine(params, CFG, stage=4, **KW)
    assert eng.mesh_info()["microbatches"] == [[0, 1], [1, 1]]
    assert _script(eng) == reference
    assert eng.pipeline_perf()["schedule_bubble_frac"] == 0.6
    eng.close()


def test_int8_prefix_cache_chunked(params):
    """int8 KV, the prefix cache and chunked prompts, replayed twice (the
    second pass hits the stage-keyed store): every token and logprob equal
    to the single-program engine's, hit for hit."""
    kw = dict(KW, n_slots=3, max_len=160, buckets=(8, 16, 32),
              prefix_cache=True, prefix_cache_blocks=64, kv_quantize="int8",
              quantize="int8")
    shared = [(i * 7) % 250 + 1 for i in range(20)]
    long_prompt = [(i * 11) % 250 + 1 for i in range(70)]   # chunked
    probes = [shared + [17, 23, 5], shared + [101, 9], long_prompt,
              [3, 7, 11]]

    def run(eng):
        out = []
        for _ in range(2):
            rids = [eng.submit(p, 10) for p in probes[:3]]
            eng.run_until_idle()
            rids.append(eng.submit(probes[3], 10))
            eng.run_until_idle()
            out += [(eng.result(r), eng.result_logprobs(r),
                     eng.cached_tokens(r)) for r in rids]
        return out

    single = LLMEngine(params, CFG, **kw)
    want = run(single)
    eng = StageShardedEngine(params, CFG, stage=2, **kw)
    assert run(eng) == want
    m, ms = eng.metrics(), single.metrics()
    assert m["prefix_hits"] == ms["prefix_hits"] >= 3
    assert m["prefix_cache"]["stages"] == 2
    assert m["prefix_cache"]["logical_blocks"] == ms["prefix_entries"] > 0
    assert m["prefix_cache"]["capacity_blocks"] == 2 * 64
    for payload in eng.kvcache.inner.payloads():   # int8 rows, f32 scales
        assert [t.dtype for t in payload] == [torch.int8, torch.float32] * 2
    single.close()
    eng.close()


def test_greedy_tokens_equal_jax_stage_engine():
    """The JAX StageShardedEngine at stage 2 (two of the virtual CPU
    devices) and the port's on the same weights: the same greedy tokens
    for three concurrent requests."""
    jcfg = jllama.LlamaConfig(vocab_size=256, d_model=64, n_layers=4,
                              n_heads=8, n_kv_heads=4, d_ff=128,
                              max_seq_len=64, attention_impl="xla",
                              remat=False, dtype=jnp.float32)
    jparams = jllama.init(jax.random.key(7), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      CFG, device="cpu")
    prompts = [PROMPT, [7, 7, 3], list(range(30, 38))]
    kw = dict(n_slots=3, max_len=48, buckets=(8,), decode_chunk=4)
    jeng = JaxStaged(jparams, jcfg, stage=2, prefer_native=False, **kw)
    rids = [jeng.submit(p, 10) for p in prompts]
    jeng.run_until_idle()
    want = [jeng.result(r) for r in rids]
    assert not jeng.mesh_info()["virtual_stages"]
    jeng.close()
    eng = StageShardedEngine(tparams, CFG, stage=2, device="cpu", **kw)
    rids = [eng.submit(p, 10) for p in prompts]
    eng.run_until_idle()
    assert [eng.result(r) for r in rids] == want
    eng.close()


def test_constructor_rejections(params):
    """The JAX engine's refusals with its messages; tensor > 1 names
    ROADMAP.md A6c-iii (the JAX engine serves it)."""
    for kw, match in (({"speculative": 4}, "speculative"),
                      ({"adapters": {"a": {}}}, "adapter"),
                      ({"mesh": object()}, "mesh"),
                      ({"kv_layout": "paged"}, "kv_layout=paged"),
                      ({"stage": 5}, "n_stages"),
                      ({"tensor": 2}, "A6c-iii"),
                      ({"stage_schedule": "bogus"}, "unknown stage schedule")):
        args = dict(KW, stage=2)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            StageShardedEngine(params, CFG, **args)


def test_pipeline_bubble_accounting(params):
    """stage_timing measures each stage's busy time under both
    schedules: the bubble in [0, 1], busy never past stages x window,
    the schedule's fraction (S-1)/(M+S-1) = 1/3; a reset clears it, and
    warmup leaves it clear."""
    for schedule in ("sync", "overlapped"):
        eng = StageShardedEngine(params, CFG, stage=2, stage_timing=True,
                                 stage_schedule=schedule, **KW)
        eng.warmup()
        assert eng.pipeline_perf()["steps"] == 0
        rids = [eng.submit(PROMPT, 8) for _ in range(2)]
        eng.run_until_idle()
        pp = eng.metrics()["pipeline"]
        assert pp["steps"] > 0 and pp["stage_timing"]
        assert pp["schedule"] == schedule and pp["microbatches"] == 2
        assert 0.0 <= pp["bubble_frac"] <= 1.0
        assert sum(pp["stage_busy_s"]) <= pp["stages"] * pp["window_s"] \
            + 1e-6
        assert pp["schedule_bubble_frac"] == pytest.approx(1 / 3, abs=1e-3)
        eng.pipeline_perf(reset=True)
        assert eng.pipeline_perf()["steps"] == 0
        for r in rids:
            eng.release(r)
        eng.close()
    # without stage_timing: the schedule alone, no measured bubble
    eng = StageShardedEngine(params, CFG, stage=2, **KW)
    eng.generate(PROMPT, 6)
    pp = eng.pipeline_perf()
    assert pp["steps"] > 0 and pp["bubble_frac"] is None
    eng.close()


def test_profiler_pipeline_bubble(params):
    """serving_decode_breakdown on a stage-sharded engine: the probes
    read every stage's slab, pipeline_bubble is the per-stage idle ms a
    step with stage_timing and None without; the engine serves the same
    tokens after."""
    kw = dict(KW, max_len=64)
    want = LLMEngine(params, CFG, **kw).generate(PROMPT, 8)
    for timing in (True, False):
        eng = StageShardedEngine(params, CFG, stage=2, stage_timing=timing,
                                 **kw)
        bd = serving_decode_breakdown(eng, iters=2)
        bubble = bd["buckets_ms"]["pipeline_bubble"]
        if timing:
            assert bubble is not None and bubble >= 0.0
            assert bd["pipeline"]["steps"] > 0
            pp = bd["pipeline"]
            idle = pp["stages"] * pp["window_s"] - sum(pp["stage_busy_s"])
            assert bubble == round(max(idle, 0.0) / (
                pp["stages"] * pp["steps"]) * 1e3, 4)
        else:
            assert bubble is None and bd["pipeline"]["bubble_frac"] is None
        assert bd["buckets_ms"]["attn_kernel"] >= 0.0
        assert eng.pipeline_perf()["steps"] == 0
        assert eng.generate(PROMPT, 8) == want
        eng.close()


def test_mesh_info_metrics_and_stage_spans(params):
    """A sampled trace gets one retrospective `stage` span a stage beside
    the base spans, with its layers."""
    eng = StageShardedEngine(params, CFG, stage=2, **KW)
    rate = TRACER.sample_rate
    TRACER.set_sample_rate(1.0)
    try:
        rid = eng.submit(PROMPT, 6, trace="stage-trace-1")
        eng.run_until_idle()
    finally:
        TRACER.set_sample_rate(rate)
    spans = {s.name: s for s in TRACER.sink.spans("stage-trace-1")}
    assert {"stage_sharded.stage0", "stage_sharded.stage1",
            "stage_sharded.decode"} <= set(spans)
    assert spans["stage_sharded.stage1"].attrs["layers"] == [2, 4]
    assert spans["stage_sharded.stage0"].kind == "stage"
    assert eng.metrics()["pipeline"]["stages"] == 2
    eng.release(rid)
    eng.close()


def test_llmmodel_parallel_stage_serves():
    """config.parallel {stage: 2} builds the stage-sharded engine in the
    supervisor's factory: predict equals a single-program engine on the
    same seed-0 weights, and metrics carry mesh, pipeline and supervisor
    sections."""
    overrides = dict(vocab_size=256, d_model=64, n_layers=4, n_heads=8,
                     n_kv_heads=4, d_ff=128, max_seq_len=64, remat=False,
                     dtype=torch.float32)
    model = LLMModel("m", model=overrides, n_slots=2, max_len=48,
                     buckets=(8,), decode_chunk=4,
                     parallel={"stage": 2, "stage_schedule": "overlapped"},
                     supervisor={"rewarm": False}, device="cpu")
    model.load()
    try:
        cfg = llama.LlamaConfig(**overrides)
        single = LLMEngine(llama.init(cfg, seed=0, device="cpu"), cfg,
                           n_slots=2, max_len=48, buckets=(8,),
                           decode_chunk=4, device="cpu")
        want = single.generate(PROMPT, 8)
        assert model.predict({"prompt_tokens": PROMPT,
                              "max_new_tokens": 8}) == {
            "output_tokens": want}
        assert isinstance(model.engine, StageShardedEngine)
        assert model.engine.stage_schedule == "overlapped"
        m = model.metrics()
        assert m["mesh"]["layout"] == "tp1xpp2"
        assert m["pipeline"]["stages"] == 2
        assert "supervisor" in m
    finally:
        model.unload()


def test_llmmodel_parallel_refusals():
    for kw, match in (
            ({"parallel": {"stage": 2}, "disaggregated": True},
             "disaggregated"),
            ({"parallel": {"stage": 2}, "kv_layout": "paged"},
             "kv_layout=paged"),
            ({"parallel": {"stage": 2}, "mesh": {"tensor": 2}}, "not both"),
            ({"parallel": {"tensor": 2}, "mesh": {"data": 2}}, "not both"),
            ({"parallel": {"stage": 0}}, ">= 1"),
            ({"parallel": {"stage": 2, "tensor": 2}}, "A6c-iii"),
            ({"parallel": {"tensor": 2}}, "A6c-iii"),
            ({"mesh": {"tensor": 2}}, "A6c-iii")):
        with pytest.raises(ValueError, match=match):
            LLMModel("m", device="cpu", **kw)

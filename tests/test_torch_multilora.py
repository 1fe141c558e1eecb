"""Multi-adapter LoRA serving in the port (the cases of
tests/test_multilora.py): many adapters of one base share the continuous
batch. A request routed through adapter X gives the greedy tokens of an
engine built on merge(base, X), in a batch that mixes X, Y and base
rows, on both engines, through every program (the prefill wave, the
chunked chain, the continuation wave of a prefix hit, decode and verify),
and the JAX multi-adapter engine's tokens on the same tiny model; the
prefix cache never shares KV across adapters; `LLMModel` serves
`adapters` and `lora` from the port's own checkpoints, through the
server's payload "adapter"."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.models import lora as jlora
from kubeflow_tpu.serving.llm import LLMEngine as JaxEngine
from kubeflow_tpu_torch import loadgen
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import lora as tlora
from kubeflow_tpu_torch.serving.agent import EngineSupervisor
from kubeflow_tpu_torch.serving.llm import LLMEngine
from kubeflow_tpu_torch.serving.llm_runtime import LLMModel, ModelError
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.serving.server import CompletionServer
from kubeflow_tpu_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(2)

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=8, n_kv_heads=4,
            d_ff=128, max_seq_len=128, rope_theta=10000.0, dtype="float32")
ENG = dict(n_slots=4, max_len=64, buckets=(16,), decode_chunk=4)
PROMPT = [5, 9, 2, 14, 3, 7]
LONG = list(range(30, 60))          # 30 tokens: a chunked chain 16 + 14
NEW = 12
ENGINES = {"slab": LLMEngine, "paged": PagedLLMEngine}


def _lora_tree(base_params, cfg, seed):
    """Adapters of `cfg` with random nonzero a and b (LoRA's b = 0 would
    leave the base model)."""
    p = jlora.init(jax.random.key(seed), cfg)
    return jax.tree.map(
        lambda x: np.asarray(jax.random.normal(
            jax.random.key(seed + 50), x.shape, jnp.float32) * 0.05),
        p["lora"])


@pytest.fixture(scope="module")
def setup():
    jcfg = jlora.LoraLlamaConfig(rank=4, alpha=8.0, llama=TINY)
    tcfg = tlora.LoraLlamaConfig(rank=4, alpha=8.0, llama=TINY)
    jbase = jllama.init(jax.random.key(0), jcfg.base_cfg)
    lx, ly = _lora_tree(jbase, jcfg, 1), _lora_tree(jbase, jcfg, 2)
    tbase = interop.from_jax_params(jax.tree.map(np.asarray, jbase),
                                    tcfg.base_cfg, device="cpu")
    tl = {k: jax.tree.map(lambda a: torch.from_numpy(np.array(a)), v)
          for k, v in
          (("x", lx), ("y", ly))}
    # the JAX multi-adapter engine's greedy tokens on the mixed batch
    jeng = JaxEngine(jbase, jcfg.base_cfg, prefer_native=False, adapters={
        "x": {"lora": lx, "alpha": 8.0}, "y": {"lora": ly, "alpha": 8.0}},
        **ENG)
    rids = {k: jeng.submit(p, NEW, adapter=a) for k, (p, a) in _MIX.items()}
    jeng.run_until_idle()
    want = {k: jeng.result(r) for k, r in rids.items()}
    return tcfg, tbase, tl, want


#: the mixed batch: name -> (prompt, adapter)
_MIX = {"x": (PROMPT, "x"), "y": (PROMPT, "y"), "base": (PROMPT, None),
        "long_y": (LONG, "y")}


def _adapters(tl):
    return {n: {"lora": tl[n], "alpha": 8.0} for n in tl}


def _merged(cfg, base, lora_tree):
    return tlora.merge({"base": base, "lora": lora_tree}, cfg,
                       stop_base_gradient=False)


@pytest.mark.parametrize("layout", ENGINES)
def test_mixed_batch_equals_merged_engines_and_jax(setup, layout):
    cfg, base, tl, want = setup
    cls = ENGINES[layout]
    multi = cls(base, cfg.base_cfg, adapters=_adapters(tl), device="cpu",
                **ENG)
    multi.warmup()
    rids = {k: multi.submit(p, NEW, adapter=a) for k, (p, a) in _MIX.items()}
    multi.run_until_idle()
    got = {k: multi.result(r) for k, r in rids.items()}
    assert got == want
    ref = {name: cls(_merged(cfg, base, tl[name]), cfg.base_cfg,
                     device="cpu", **ENG) for name in ("x", "y")}
    ref["base"] = cls(base, cfg.base_cfg, device="cpu", **ENG)
    assert got["x"] == ref["x"].generate(PROMPT, NEW)
    assert got["y"] == ref["y"].generate(PROMPT, NEW)
    assert got["long_y"] == ref["y"].generate(LONG, NEW)
    assert got["base"] == ref["base"].generate(PROMPT, NEW)
    # the adapters change the model (else this proves nothing)
    assert len({tuple(got[k]) for k in ("x", "y", "base")}) == 3
    assert multi.metrics()["adapters_loaded"] == ["x", "y"]
    assert multi._adapter_idx == {"x": 1, "y": 2}


def test_adapter_errors_are_the_jax_engines(setup):
    cfg, base, tl, _ = setup
    jcfg = jlora.LoraLlamaConfig(rank=4, alpha=8.0, llama=TINY)
    jbase = jllama.init(jax.random.key(0), jcfg.base_cfg)
    jl = jax.tree.map(lambda t: t.numpy(), tl["x"])
    jeng = JaxEngine(jbase, jcfg.base_cfg, prefer_native=False,
                     adapters={"x": {"lora": jl, "alpha": 8.0}}, **ENG)
    teng = LLMEngine(base, cfg.base_cfg, adapters={"x": {
        "lora": tl["x"], "alpha": 8.0}}, device="cpu", **ENG)
    msgs = []
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="unknown adapter") as e:
            eng.submit([1, 2, 3], 4, adapter="nope")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    bad = {t: dict(ab) for t, ab in tl["y"].items()}
    bad["wq"] = {"a": bad["wq"]["a"][..., :2], "b": bad["wq"]["b"][:, :2]}
    typo = {"Wq" if t == "wq" else t: ab for t, ab in tl["y"].items()}
    for lora_tree, match in ((bad, "rank"), (typo, "targets")):
        msgs = []
        for eng, conv in ((JaxEngine, lambda t: t.numpy()),
                          (LLMEngine, lambda t: t)):
            kw = (dict(prefer_native=False) if eng is JaxEngine
                  else dict(device="cpu"))
            b = jbase if eng is JaxEngine else base
            with pytest.raises(ValueError, match=match) as e:
                eng(b, cfg.base_cfg if eng is LLMEngine else jcfg.base_cfg,
                    adapters={"x": {"lora": jax.tree.map(conv, tl["x"]),
                                    "alpha": 8.0},
                              "z": {"lora": jax.tree.map(conv, lora_tree),
                                    "alpha": 8.0}}, **ENG, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # an engine without adapters runs the base programs: no slot indices,
    # no stack, and the base tokens
    plain = LLMEngine(base, cfg.base_cfg, device="cpu", **ENG)
    assert plain.adapters is None and "aids" not in plain.cache
    assert plain._lora_kw(None) == {}
    assert "adapters_loaded" not in plain.metrics()
    with pytest.raises(ValueError, match="unknown adapter"):
        plain.submit([1, 2, 3], 4, adapter="x")


@pytest.mark.parametrize("layout", ENGINES)
def test_adapters_compose_with_speculation(setup, layout):
    cfg, base, tl, want = setup
    cls = ENGINES[layout]
    multi = cls(base, cfg.base_cfg, adapters=_adapters(tl), speculative=3,
                spec_ngram=2, device="cpu", **ENG)
    multi.warmup()
    rids = {k: multi.submit(p, NEW, adapter=a) for k, (p, a) in _MIX.items()}
    multi.run_until_idle()
    assert {k: multi.result(r) for k, r in rids.items()} == want
    assert multi.metrics()["spec_verify_rounds"] > 0
    # the slots' adapter indices as the last prefill wrote them
    assert sorted(multi.cache["aids"].tolist()) == [0, 1, 2, 2]


@pytest.mark.parametrize("layout", ENGINES)
def test_prefix_cache_keyed_by_adapter(setup, layout):
    """The same prompt through two adapters never shares prefix KV: x
    twice (the second hits x's blocks), then y (a miss, exact), then y
    again (a hit in y's namespace)."""
    cfg, base, tl, _ = setup
    cls = ENGINES[layout]
    multi = cls(base, cfg.base_cfg, adapters=_adapters(tl),
                prefix_cache=True, max_prefixes=4, device="cpu", **ENG)
    refs = {n: cls(_merged(cfg, base, tl[n]), cfg.base_cfg, device="cpu",
                   **ENG) for n in ("x", "y")}
    prompt = list(range(1, 25))      # 24 tokens: a 16-token block + tail
    for name, hits in (("x", 0), ("x", 1), ("y", 1), ("y", 2)):
        assert multi.generate(prompt, 10, adapter=name) == \
            refs[name].generate(prompt, 10)
        assert multi.metrics()["prefix_hits"] == hits, name
    assert multi.metrics()["prefix_misses"] == 2
    assert multi.kvcache.cached_prefix_len(prompt, namespace=1) == 16
    assert multi.kvcache.cached_prefix_len(prompt, namespace=2) == 16
    assert multi.kvcache.cached_prefix_len(prompt, namespace=0) == 0


def _save(path, params):
    mgr = CheckpointManager(path)
    mgr.save(1, {"params": params, "step": 1}, force=True)
    mgr.close()


def _predict(server, body):
    req = urllib.request.Request(
        server.url + "/v1/models/m:predict",
        data=json.dumps({"instances": [body]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["predictions"][0]["output_tokens"]


def test_llmmodel_serves_adapters_and_lora_checkpoints(setup, tmp_path):
    """`adapters` reads only each llama_lora checkpoint's adapter shards
    beside a base checkpoint and routes the payload's "adapter" through
    the server; `lora` serves a llama_lora checkpoint merged; both give a
    merged engine's tokens. config.lora without a checkpoint raises
    ModelError, an unknown adapter is a 400."""
    cfg, base, tl, _ = setup
    _save(str(tmp_path / "base"), base)
    _save(str(tmp_path / "ad-x"), {"base": base, "lora": tl["x"]})
    _save(str(tmp_path / "ad-y"), {"base": base, "lora": tl["y"]})
    serving = dict(model=TINY, n_slots=2, max_len=64, buckets=(16,),
                   device="cpu")
    want = {n: LLMEngine(_merged(cfg, base, tl[n]), cfg.base_cfg,
                         device="cpu", n_slots=2, max_len=64, buckets=(16,))
            .generate(PROMPT, 8) for n in ("x", "y")}
    want[None] = LLMEngine(base, cfg.base_cfg, device="cpu", n_slots=2,
                           max_len=64, buckets=(16,)).generate(PROMPT, 8)
    m = LLMModel("m", checkpoint=str(tmp_path / "base"), adapters={
        n: {"checkpoint": str(tmp_path / f"ad-{n}"), "rank": 4,
            "alpha": 8.0} for n in ("x", "y")}, **serving)
    m.load()
    server = CompletionServer(m).start()
    try:
        for name in ("x", "y", None):
            body = {"prompt_tokens": PROMPT, "max_new_tokens": 8}
            if name:
                body["adapter"] = name
            assert _predict(server, body) == want[name], name
        assert m.engine._adapter_idx == {"x": 1, "y": 2}
        with pytest.raises(urllib.error.HTTPError) as e:
            _predict(server, {"prompt_tokens": PROMPT, "max_new_tokens": 4,
                              "adapter": "nope"})
        assert e.value.code == 400
    finally:
        server.stop()
        m.unload()
    merged = LLMModel("m", checkpoint=str(tmp_path / "ad-y"),
                      lora={"rank": 4, "alpha": 8.0}, **serving)
    merged.load()
    try:
        assert merged.predict({"prompt_tokens": PROMPT,
                               "max_new_tokens": 8})["output_tokens"] \
            == want["y"]
    finally:
        merged.unload()
    with pytest.raises(ModelError, match="requires a checkpoint"):
        LLMModel("m", lora={"rank": 4}, **serving).load()
    with pytest.raises(ModelError, match="adapter 'x'"):
        LLMModel("m", checkpoint=str(tmp_path / "base"), adapters={
            "x": {"checkpoint": str(tmp_path / "none"), "rank": 4}},
            **serving).load()


def test_multi_tenant_lora_replays_with_its_adapters(setup):
    """The committed multi_tenant_lora scenario (miniature) through the
    runner into a supervised engine that loads a0..a3: the adapter check
    passes, every request completes, and the adapter rows' tokens are
    their merged engines'."""
    cfg, base, tl, _ = setup
    names = ("a0", "a1", "a2", "a3")
    trees = {n: tl["x" if i % 2 else "y"] for i, n in enumerate(names)}
    trees["a2"] = jax.tree.map(lambda t: t * 2.0, tl["x"])
    eng_kw = dict(n_slots=2, max_len=48, buckets=(8, 16), decode_chunk=4)
    sup = EngineSupervisor(lambda: LLMEngine(
        base, cfg.base_cfg, adapters={n: {"lora": trees[n], "alpha": 8.0}
                                      for n in names}, device="cpu",
        **eng_kw))
    assert sup._adapter_idx == {n: i + 1 for i, n in enumerate(names)}
    s = loadgen.miniature(loadgen.load_scenario("multi_tenant_lora"),
                          vocab=256, max_prompt_len=14, duration_s=2.0,
                          rate_rps=6.0)
    trace = loadgen.generate_trace(s.trace)
    seen = {}
    orig = sup.release

    def release(rid):
        seen[rid] = sup.result(rid)
        orig(rid)

    sup.release = release
    out = loadgen.run_scenario(sup, s, max_wall_s=120)
    agg = out["aggregate"]
    assert agg["completed"] + agg["rejected"] == agg["n_requests"] \
        == len(trace.requests) > 0
    routed = {r.adapter for r in trace.requests}
    assert routed - {None} and routed <= set(names) | {None}
    # one request of each routed adapter again, alone, against its merged
    # engine
    for r in trace.requests:
        if r.adapter in routed:
            routed.discard(r.adapter)
            tree = trees[r.adapter] if r.adapter else None
            ref = LLMEngine(_merged(cfg, base, tree) if tree else base,
                            cfg.base_cfg, device="cpu", **eng_kw)
            assert sup.engine.generate(r.prompt, r.max_new_tokens,
                                       adapter=r.adapter) == \
                ref.generate(r.prompt, r.max_new_tokens)
    sup.close()

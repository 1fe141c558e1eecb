"""The port's disaggregated prefill/decode serving (serving/disagg.py, the
`PrefillEngine`/`DecodeEngine` roles) on the CPU against the JAX
`DisaggregatedEngine` on `LlamaConfig.tiny()` at f32: greedy tokens equal
to the JAX coordinator's and to the port's colocated engine through both
handoffs (a bypass, a handed-off and a chunked prompt, then the same again
over warm caches), int8 KV through the serialized handoff equal to
zero-copy, the `PrefillQueue` pop order and the `KVHandoff` units against
the JAX ones, backpressure, the request_timing split, cancel in every
stage, the metrics and accounting keys (and the roles' launch counts),
the refused configurations, a
prefill-role crash, `LLMModel(disaggregated=...)` against the JAX
`LLMModel` (with the server's /healthz disagg block), and the serving
breakdown's kv_handoff bucket."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.kvcache import RadixKVCache as JaxRadix
from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu.serving import disagg as jdisagg
from kubeflow_tpu.serving.agent import EngineSupervisor as JaxSupervisor
from kubeflow_tpu.serving.llm import DecodeEngine as JaxDecode
from kubeflow_tpu.serving.llm import PrefillEngine as JaxPrefill
from kubeflow_tpu_torch.chaos import (FaultScriptConfig, FaultSpec,
                                      generate_fault_script)
from kubeflow_tpu_torch.kvcache import RadixKVCache
from kubeflow_tpu_torch.models import interop
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.serving import disagg
from kubeflow_tpu_torch.serving.agent import EngineSupervisor
from kubeflow_tpu_torch.serving.llm import (DecodeEngine, LLMEngine,
                                            PrefillEngine)
from kubeflow_tpu_torch.serving.paged import PagedLLMEngine
from kubeflow_tpu_torch.serving.scheduler import PromptTooLong, QueueFull
from kubeflow_tpu_torch.training.profiling import serving_decode_breakdown

torch.set_num_threads(2)

ENGINE = dict(n_slots=2, max_len=64, buckets=(8, 16), decode_chunk=1)
PROBES = [
    [5, 6, 7],                  # shorter than one block: bypass
    list(range(1, 20)),         # two blocks and a tail: handed off
    list(range(3, 40)),         # longer than the largest bucket: chunked
]
NEW = 10


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(tllama.LlamaConfig.tiny(),
                               dtype=torch.float32)
    jparams = jllama.init(jax.random.key(0), jcfg)
    tparams = interop.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def port_disagg(tiny, handoff="zero_copy", prefill_kw=None, decode_kw=None,
                **kw):
    _, tcfg, _, tparams = tiny
    pkw = dict(ENGINE, device="cpu", **(prefill_kw or {}))
    dkw = dict(ENGINE, device="cpu", **(decode_kw or {}))
    return disagg.DisaggregatedEngine(
        EngineSupervisor(lambda: PrefillEngine(tparams, tcfg, **pkw)),
        EngineSupervisor(lambda: DecodeEngine(tparams, tcfg, **dkw)),
        handoff=handoff, **kw)


def _traffic(co):
    """Greedy tokens of the probes, twice (the second pass over the
    caches the first one filled), and the coordinator's handoff and
    bypass counts and the decode role's full prefills."""
    tokens = [co.generate(p, NEW) for p in PROBES + PROBES]
    dg = co.metrics()["disagg"]
    return tokens, {k: dg["handoff"][k] for k in
                    ("handoffs", "blocks_sent", "tokens_sent",
                     "bytes_sent")}, dg["bypass"], dg["decode_full_prefills"]


@pytest.fixture(scope="module")
def jax_run(tiny):
    jcfg, _, jparams, _ = tiny
    kw = dict(ENGINE, prefer_native=False)
    co = jdisagg.DisaggregatedEngine(
        JaxSupervisor(lambda: JaxPrefill(jparams, jcfg, **kw)),
        JaxSupervisor(lambda: JaxDecode(jparams, jcfg, **kw)),
        handoff="serialized")
    try:
        out = _traffic(co)
        keys = (set(co.metrics()["disagg"]), set(co.accounting()),
                set(co.accounting()["prefill"]))
    finally:
        co.close()
    return out, keys


@pytest.fixture(scope="module")
def colocated(tiny):
    _, tcfg, _, tparams = tiny
    eng = LLMEngine(tparams, tcfg, prefix_cache=True, device="cpu",
                    **ENGINE)
    return [eng.generate(p, NEW) for p in PROBES + PROBES]


@pytest.mark.parametrize("handoff", ["zero_copy", "serialized"])
def test_greedy_tokens_match_jax_and_colocated(tiny, jax_run, colocated,
                                               handoff):
    (want, jstats, jbypass, jfull), _ = jax_run
    co = port_disagg(tiny, handoff)
    try:
        tokens, stats, bypass, full = _traffic(co)
    finally:
        co.close()
    assert tokens == want == colocated
    assert (bypass, full) == (jbypass, jfull) == (2, 0)
    assert stats["blocks_sent"] > 0
    if handoff == "serialized":
        # the f32 blocks are the JAX blocks' shapes: the same bytes cross
        assert stats == jstats
    else:
        assert stats == dict(jstats, bytes_sent=0)


def test_int8_kv_through_serialized_equals_zero_copy(tiny):
    """int8 weights and KV: the serialized handoff rebuilds each block's
    int8 rows and f32 scales with their dtypes, counts their bytes, and
    gives zero-copy's tokens and the colocated engine's."""
    _, tcfg, _, tparams = tiny
    q = dict(quantize="int8", kv_quantize="int8")
    runs = {}
    for handoff in ("zero_copy", "serialized"):
        co = port_disagg(tiny, handoff, prefill_kw=q, decode_kw=q)
        try:
            runs[handoff] = [co.generate(p, NEW) for p in PROBES]
            store = co.kvcache
            blocks = store.payloads()
            assert blocks and all(
                [t.dtype for t in b] == [torch.int8, torch.float32,
                                         torch.int8, torch.float32]
                for b in blocks)
            h = co.handoff.stats()
            if handoff == "serialized":
                per_block = sum(t.nbytes for t in blocks[0])
                assert h["bytes_sent"] == h["blocks_sent"] * per_block > 0
        finally:
            co.close()
    ref = LLMEngine(tparams, tcfg, prefix_cache=True, device="cpu", **q,
                    **ENGINE)
    assert runs["serialized"] == runs["zero_copy"] == [
        ref.generate(p, NEW) for p in PROBES]


def _queue_script(mod):
    """One push/pop/remove/done script on a module's PrefillQueue: the
    rids in pop order, with the depth and in-flight count after each."""
    def job(rid, tenant, plen):
        return mod._DisaggReq(rid=rid, prompt=list(range(plen)), max_new=4,
                              kw={}, tenant=tenant, adapter=None,
                              submit_s=0.0, deadline_at=None)

    q = mod.PrefillQueue()
    rem = lambda j: len(j.prompt)   # noqa: E731
    jobs = {i: job(i, t, n) for i, (t, n) in enumerate(
        [("a", 100), ("a", 10), ("b", 50), ("a", 5), (None, 30),
         ("b", 7), ("c", 500), (None, 8)], start=1)}
    out = []
    for i in (1, 2, 3, 4):
        q.push(jobs[i])
    out.append(q.pop(rem).rid)
    out.append(q.pop(rem).rid)
    q.push(jobs[5])
    q.push(jobs[6])
    out.append(q.remove(jobs[3]))
    out.append(q.remove(jobs[3]))
    out.append(q.pop(rem).rid)
    q.done("a")
    q.push(jobs[7])
    q.push(jobs[8])
    while (j := q.pop(rem)) is not None:
        out.append((j.rid, q.depth(), q.inflight()))
        q.done(j.tenant)
    out.append((q.depth(), q.inflight(), q.enqueued, q.popped))
    return out


def test_prefill_queue_pop_order_matches_jax():
    got = _queue_script(disagg)
    assert got == _queue_script(jdisagg)
    # the shortest first, then the tenant with nothing in flight
    assert got[:2] == [4, 3]


def test_kvhandoff_inserts_dedupes_and_degrades_like_jax():
    def script(handoff_cls, radix, payload):
        target = radix(4, 16)
        h = handoff_cls(lambda: target)
        toks = list(range(1, 13))
        blocks = [payload(i) for i in range(4)]
        sent = [h.send(toks, blocks[:3]),          # a new chain
                h.send(toks, blocks[:3]),          # held already: nothing
                h.send(toks + [13, 14, 15, 16], blocks)]   # one more block
        m = target.match(toks)
        chain = m.tokens
        target.release(m)
        down = handoff_cls(lambda: None)            # decode engine down
        return sent, chain, h.stats(), down.send(toks, blocks), down.stats()

    got = script(disagg.KVHandoff, RadixKVCache,
                 lambda i: (torch.full((2, 1, 4, 1, 2), float(i)),))
    want = script(jdisagg.KVHandoff, JaxRadix, lambda i: f"b{i}")
    assert got == want
    assert got[0] == [3, 0, 1] and got[3] == 0
    ser = script(disagg.SerializedKVHandoff, RadixKVCache,
                 lambda i: (torch.full((2, 1, 4, 1, 2), float(i)),))
    assert ser[2]["bytes_sent"] == 4 * 16 * 4   # four f32 blocks of 16


def test_backpressure_degrades_and_never_deadlocks(tiny):
    """A decode store too small for the offered prefixes: every request
    completes (a partial or empty handoff, the decode role computes the
    rest), and the blocks in flight drain to 0."""
    co = port_disagg(tiny, decode_kw=dict(prefix_cache_blocks=2))
    try:
        rids = [co.submit(list(range(1 + i, 20 + i)), 4) for i in range(4)]
        deadline = time.monotonic() + 60
        while not all(co.is_done(r) for r in rids):
            co.step()
            assert time.monotonic() < deadline, "backpressure deadlock"
        assert all(co.finish_reason(r) == "length" for r in rids)
        assert co.metrics()["disagg"]["blocks_in_flight"] == 0
        acc = co.accounting()
        assert acc["lost"] == 0 and acc["in_flight"] == 0
    finally:
        co.close()


def test_request_timing_split_partitions_the_wall(tiny):
    co = port_disagg(tiny)
    try:
        rid = co.submit(list(range(1, 20)), 6)
        co.run_until_idle()
        tm = co.request_timing(rid)
        assert tm["prompt_len"] == 19 and tm["n_tokens"] == 6
        assert tm["cached_prefix_len"] == 16   # the handed-off blocks
        total = (tm["finish_s"] - tm["submit_s"]) * 1e3
        parts = [tm[k] for k in ("queue_wait_ms", "prefill_ms",
                                 "handoff_ms", "decode_ms")]
        assert all(v is not None and v >= 0 for v in parts), tm
        assert sum(parts) == pytest.approx(total, abs=0.01)
        # a bypass never harvests a prefill
        rid = co.submit([5, 6, 7], 4)
        co.run_until_idle()
        tm = co.request_timing(rid)
        assert tm["handoff_ms"] is None and tm["prefill_ms"] is not None
    finally:
        co.close()


def test_cancel_in_every_stage(tiny):
    """Each stage held open by a gate: queued (no dispatch), prefill (the
    prefill role's step held), handoff (the send held), decode_wait (the
    decode role refusing) and decode (a bypass); every cancel is final and
    nothing is lost."""
    co = port_disagg(tiny)
    gate = threading.Event()
    long = list(range(1, 20))

    def held(fn):
        def run(*a, **k):
            gate.wait(30)
            return fn(*a, **k)
        return run

    def stage_of(rid, stage):
        deadline = time.monotonic() + 30
        while co._reqs[rid].stage != stage:
            assert time.monotonic() < deadline, co._reqs[rid].stage
            time.sleep(0.002)

    try:
        co._max_inflight = 0
        rid = co.submit(long, 4)
        time.sleep(0.05)
        stage_of(rid, "queued")
        assert co.cancel(rid) and co.finish_reason(rid) == "cancelled"
        co.release(rid)
        co._max_inflight = 2
        for stage, obj, name in (("prefill", co.prefill, "step"),
                                 ("handoff", co.handoff, "send")):
            gate.clear()
            setattr(obj, name, held(getattr(obj, name)))
            rid = co.submit(long, 4)
            stage_of(rid, stage)
            assert co.cancel(rid) and co.is_done(rid)
            gate.set()
            co.release(rid)
            delattr(obj, name)
        submit = co.decode.submit
        co.decode.submit = lambda *a, **k: (_ for _ in ()).throw(
            QueueFull("full"))
        rid = co.submit(long + [1], 4)
        stage_of(rid, "decode_wait")
        assert co.cancel(rid) and co.finish_reason(rid) == "cancelled"
        co.release(rid)
        co.decode.submit = submit
        rid = co.submit([3, 4, 5], 40)          # bypass: in decode at once
        assert co._reqs[rid].stage == "decode"
        assert co.cancel(rid)
        co.run_until_idle()
        assert co.finish_reason(rid) == "cancelled"
        co.release(rid)
        acc = co.accounting()
        assert acc["lost"] == 0 and acc["cancelled"] == 5
    finally:
        gate.set()
        co.close()


def test_metrics_and_accounting_keys_equal_jax(tiny, jax_run):
    _, (dg_keys, acc_keys, role_keys) = jax_run
    co = port_disagg(tiny)
    try:
        co.generate(PROBES[1], 4)
        m = co.metrics()
        assert set(m["disagg"]) == dg_keys
        acc = co.accounting()
        assert set(acc) == acc_keys and set(acc["prefill"]) == role_keys
        assert set(acc["decode"]) == role_keys
        assert m["supervisor"]["lost"] == 0
        assert m["disagg_full_prefills"] == 0
        assert m["disagg"]["pump_errors"] == 0
    finally:
        co.close()
    # the roles' threads count their kernel launches apart, and a graph
    # capture's recording on one thread leaves the other's counts alone
    _build.reset_launches()

    def role(tag, n):
        _build.set_thread_tag(tag)
        for _ in range(n):
            _build.count_launch("quant_matmul", m=1)

    other = threading.Thread(target=role, args=("prefill", 3))
    with _build.recording() as rec:
        other.start()
        other.join()
        _build.count_launch("flash_decode", b=1)
    role("decode", 2)
    _build.set_thread_tag(None)
    assert _build.TAGGED == {"prefill": {"quant_matmul": 3},
                             "decode": {"quant_matmul": 2}}
    assert _build.LAUNCHES["quant_matmul"] == 5
    assert _build.LAUNCHES["flash_decode"] == 0
    assert rec == ({"flash_decode": 1}, {"flash_decode": {(("b", 1),): 1}})
    _build.reset_launches()


def test_refused_configurations(tiny):
    """Paged roles, unequal block sizes, roles without the cache, bad
    submit arguments, and the LLMModel keys JAX refuses with them."""
    from kubeflow_tpu_torch.serving.llm_runtime import LLMModel

    _, tcfg, _, tparams = tiny
    kw = dict(ENGINE, device="cpu", prefix_cache=True)

    def build(pre, dec):
        return disagg.DisaggregatedEngine(EngineSupervisor(pre),
                                          EngineSupervisor(dec))

    with pytest.raises(ValueError, match="kv_layout=slab"):
        build(lambda: PrefillEngine(tparams, tcfg, **ENGINE, device="cpu"),
              lambda: PagedLLMEngine(tparams, tcfg, **kw))
    with pytest.raises(ValueError, match="block sizes differ"):
        build(lambda: PrefillEngine(tparams, tcfg, **ENGINE, device="cpu"),
              lambda: DecodeEngine(tparams, tcfg, **dict(
                  ENGINE, buckets=(12, 24)), device="cpu"))
    with pytest.raises(ValueError, match="require prefix_cache"):
        build(lambda: PrefillEngine(tparams, tcfg, **ENGINE, device="cpu"),
              lambda: LLMEngine(tparams, tcfg, **ENGINE, device="cpu"))
    co = port_disagg(tiny)
    try:
        with pytest.raises(ValueError):
            co.submit([1, 2, 3], 4, temperature=float("nan"))
        with pytest.raises(ValueError, match="unknown adapter"):
            co.submit([1, 2, 3], 4, adapter="nope")
        with pytest.raises(ValueError, match="tenant"):
            co.submit([1, 2, 3], 4, tenant="")
        with pytest.raises(PromptTooLong):
            co.submit(list(range(200)), 4)
        assert co.accounting()["accepted"] == 0
    finally:
        co.close()
    for cfg, msg in (({"supervised": False}, "requires supervised"),
                     ({"kv_layout": "paged"}, "kv_layout=paged"),
                     ({"parallel": {"stage": 2}}, "does not compose")):
        with pytest.raises(ValueError, match=msg):
            LLMModel("m", device="cpu", disaggregated=True, **cfg)


def test_prefill_role_crash_replays_byte_identically(tiny, colocated):
    """The prefill role is killed before a chunked prompt arrives: its
    supervisor's journal replays the prefill on the new engine, the
    handoff goes on, the tokens are the colocated engine's, and nothing
    is lost on either role."""
    co = port_disagg(tiny)
    try:
        co.generate(PROBES[1], NEW)
        psup = co.prefill
        psup.arm_faults(generate_fault_script(FaultScriptConfig(
            seed=17, duration_s=1.0,
            faults=(FaultSpec("backend_crash", 1, (0.0, 0.0)),)),
            name="now"))
        deadline = time.monotonic() + 15
        while not psup.degraded and time.monotonic() < deadline:
            time.sleep(0.002)
        assert psup.degraded
        assert co.generate(PROBES[2], NEW) == colocated[2]
        assert psup.accounting()["restarts"] == 1
        acc = co.accounting()
        assert acc["lost"] == 0 and acc["decode"]["restarts"] == 0
        assert co.metrics()["disagg"]["prefill_restarts"] == 1
    finally:
        co.close()


def test_llm_model_disaggregated_matches_the_jax_llm_model(tiny):
    """LLMModel(disaggregated=True) with the serialized handoff answers
    the JAX LLMModel's completions and predictions, shares one weight
    copy between its roles, reports handoff_ms under usage_timing, and
    the port's /healthz disagg block has the JAX server's keys."""
    from kubeflow_tpu.serving.model import ModelRepository, load_model
    from kubeflow_tpu.serving.server import ModelServer
    from kubeflow_tpu_torch.serving.llm_runtime import LLMModel
    from kubeflow_tpu_torch.serving.server import CompletionServer

    jcfg, tcfg, _, tparams = tiny
    cfg = dict(n_slots=2, max_len=16, buckets=[8], decode_chunk=1,
               disaggregated=True, disagg={"handoff": "serialized"},
               usage_timing=True, seed=0)
    jm = load_model("llama", "m", None, model=dataclasses.asdict(jcfg),
                    **cfg)
    repo = ModelRepository()
    repo.register(jm)
    tm = LLMModel("m", device="cpu", params=tparams, llama_config=tcfg,
                  **cfg)
    server = CompletionServer(tm)
    payloads = [{"prompt_tokens": list(range(1, 10)), "max_new_tokens": 6},
                {"prompt_tokens": [4, 5], "max_new_tokens": 5},
                {"prompt_tokens": list(range(2, 12)), "max_new_tokens": 5}]
    try:
        want = jm.predict(payloads)
        assert tm.predict(payloads) == want
        got = tm.complete(payloads[0])
        assert got["token_ids"] == jm.complete(payloads[0])["token_ids"]
        assert got["timing"]["handoff_ms"] is not None
        assert got["cached_tokens"] == 8
        roles = [tm.prefill_supervisor.engine, tm.supervisor.engine]
        assert roles[0].params["lm_head"] is roles[1].params["lm_head"]
        health = server.health()["disagg"]["m"]
        jserver = ModelServer(repo).start()
        try:
            assert set(health) == set(jserver.health()["disagg"]["m"])
        finally:
            jserver.stop()
        assert health["handoff"]["transport"] == "serialized"
        assert health["bypass"] == 1
    finally:
        server.stop()
        tm.unload()
        jm.unload()


def test_kv_handoff_bucket_priced_on_slab_none_on_paged(tiny):
    _, tcfg, _, tparams = tiny
    kw = dict(ENGINE, device="cpu", prefix_cache=True)
    slab = serving_decode_breakdown(LLMEngine(tparams, tcfg, **kw), iters=2)
    assert isinstance(slab["buckets_ms"]["kv_handoff"], float)
    assert slab["buckets_ms"]["kv_handoff"] >= 0
    cold = serving_decode_breakdown(
        LLMEngine(tparams, tcfg, **ENGINE, device="cpu"), iters=2)
    paged = serving_decode_breakdown(PagedLLMEngine(tparams, tcfg, **kw),
                                     iters=2)
    assert cold["buckets_ms"]["kv_handoff"] is None
    assert paged["buckets_ms"]["kv_handoff"] is None

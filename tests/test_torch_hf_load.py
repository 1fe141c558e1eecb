"""HF checkpoints in the port: its own safetensors reader against the
`safetensors` package, `config_from_hf` field for field and `load_hf`
leaf for leaf bit-equal to the JAX package's, on tiny
`transformers.LlamaForCausalLM` directories saved as the published
checkpoints are (single-file and sharded, untied and tied, f32 and bf16
param_dtype, an f32 and a bf16 file), and the loaded model's logits
against `transformers`'."""

import dataclasses
import json
import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import llama as jllama
from kubeflow_tpu_torch.models import llama as tllama
from kubeflow_tpu_torch.models import safetensors as tsafe

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")
from safetensors import safe_open  # noqa: E402

torch.set_num_threads(2)

# a 2-layer f32 model evaluated by two frameworks: f32 rounding only (the
# tolerance of tests/test_torch_llama.py)
ATOL, RTOL = 1e-4, 1e-4


def _save_hf(path, tied: bool, dtype=torch.float32, shard: str | None = None,
             seed: int = 0) -> str:
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=128,
        max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=tied)
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(hf_cfg).eval().to(dtype)
    kw = {"max_shard_size": shard} if shard else {}
    model.save_pretrained(path, safe_serialization=True, **kw)
    return str(path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    return {
        "untied": _save_hf(root / "untied", False),
        "tied": _save_hf(root / "tied", True, seed=1),
        "sharded-bf16": _save_hf(root / "sharded", False, torch.bfloat16,
                                 shard="40KB", seed=2),
    }


TENSORS = {
    "bf16": torch.randn(3, 5).to(torch.bfloat16),
    "f16": torch.randn(7).half(),
    "f32": torch.randn(2, 3, 4),
    "i8": torch.randint(-128, 127, (9,), dtype=torch.int8),
    "i32": torch.randint(-2**31, 2**31 - 1, (2, 2), dtype=torch.int32),
    "i64": torch.randint(-2**62, 2**62, (3,), dtype=torch.int64),
    "scalar": torch.tensor(1.5).to(torch.bfloat16),
    "empty": torch.empty(0, 3),
}


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_reader_matches_safe_open(tmp_path, layout):
    """Every dtype the reader takes, a 0-d and an empty tensor, the
    metadata; one file, or the tensors spread over two with an index."""
    names = sorted(TENSORS)
    parts = ([names] if layout == "single"
             else [names[:4], names[4:]])
    for i, part in enumerate(parts):
        safetensors_torch.save_file(
            {n: TENSORS[n] for n in part},
            str(tmp_path / f"model-{i}.safetensors"),
            metadata={"format": "pt", "part": str(i)})
    seen = set()
    for i in range(len(parts)):
        fn = str(tmp_path / f"model-{i}.safetensors")
        with tsafe.SafeFile(fn) as got, safe_open(fn, framework="pt") as want:
            assert sorted(got.keys()) == sorted(want.keys())
            assert got.metadata() == want.metadata()
            for name in got.keys():
                a, b = got.get_tensor(name), want.get_tensor(name)
                assert a.dtype == b.dtype and a.shape == b.shape, name
                assert torch.equal(a, b), name
                assert got.shape(name) == tuple(b.shape)
                seen.add(name)
    assert seen == set(names)


def test_reader_rejects_malformed_files(tmp_path):
    fn = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file({"a": torch.arange(4, dtype=torch.float64)},
                                fn)
    with pytest.raises(tsafe.SafetensorsError, match="F64"):
        tsafe.SafeFile(fn)

    def write(header: dict, data: bytes) -> str:
        head = json.dumps(header).encode()
        with open(fn, "wb") as f:
            f.write(struct.pack("<Q", len(head)) + head + data)
        return fn

    with pytest.raises(tsafe.SafetensorsError, match="offsets"):
        tsafe.SafeFile(write({"a": {"dtype": "F32", "shape": [4],
                                    "data_offsets": [0, 12]}}, bytes(16)))
    with pytest.raises(tsafe.SafetensorsError, match="offsets"):
        tsafe.SafeFile(write({"a": {"dtype": "F32", "shape": [4],
                                    "data_offsets": [0, 16]}}, bytes(8)))
    with open(fn, "wb") as f:
        f.write(struct.pack("<Q", 1 << 40))
    with pytest.raises(tsafe.SafetensorsError, match="header length"):
        tsafe.SafeFile(fn)
    with pytest.raises(KeyError):
        tsafe.SafeFile(write({}, b"")).get_tensor("a")


def test_config_from_hf_matches_jax(dirs):
    for path in dirs.values():
        want = jllama.config_from_hf(path)
        got = tllama.config_from_hf(path)
        for f in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq_len", "rope_theta",
                  "norm_eps"):
            assert getattr(got, f) == getattr(want, f), f
        assert tllama.is_hf_checkpoint(path)
    got = tllama.config_from_hf(dirs["untied"], d_ff=256)
    assert got.d_ff == 256
    assert not tllama.is_hf_checkpoint(os.path.dirname(dirs["untied"]))


def _np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("which,pd", [
    ("untied", "float32"), ("untied", "bfloat16"), ("tied", "float32"),
    ("tied", "bfloat16"), ("sharded-bf16", "float32")])
def test_load_hf_bit_equal_to_jax(dirs, which, pd):
    path = dirs[which]
    jp, jcfg = jllama.load_hf(path, jllama.config_from_hf(
        path, param_dtype=getattr(jnp, pd)))
    tp, tcfg = tllama.load_hf(path, tllama.config_from_hf(
        path, param_dtype=getattr(torch, pd)), device="cpu")
    assert tcfg.n_layers == jcfg.n_layers
    pairs = [(k, jp[k], tp[k]) for k in ("embed", "final_norm", "lm_head")]
    pairs += [(k, jp["layers"][k], tp["layers"][k]) for k in jp["layers"]]
    assert set(tp["layers"]) == set(jp["layers"])
    for name, want, got in pairs:
        assert got.dtype == getattr(torch, pd), name
        assert got.is_contiguous(), name
        np.testing.assert_array_equal(got.float().numpy(), _np(want),
                                      err_msg=name)
    if which == "tied":
        assert torch.equal(tp["lm_head"], tp["embed"].t())


def test_load_hf_quantize_is_quantize_params(dirs):
    """quantize="int8" quantizes each leaf as it lands: the same bytes as
    quantize_params of the full-width load."""
    path = dirs["untied"]
    cfg = tllama.config_from_hf(path)
    full, _ = tllama.load_hf(path, cfg, device="cpu")
    want = tllama.quantize_params(full)
    got, _ = tllama.load_hf(path, cfg, device="cpu", quantize="int8")
    for k in tllama.QUANT_LEAVES:
        for part in ("q", "s"):
            assert torch.equal(got["layers"][k][part],
                               want["layers"][k][part]), (k, part)
    for part in ("q", "s"):
        assert torch.equal(got["lm_head"][part], want["lm_head"][part])
    assert torch.equal(got["embed"], want["embed"])


def test_load_hf_logits_match_transformers(dirs):
    path = dirs["untied"]
    model = transformers.LlamaForCausalLM.from_pretrained(path).eval()
    cfg = dataclasses.replace(tllama.config_from_hf(path),
                              dtype=torch.float32, remat=False)
    params, cfg = tllama.load_hf(path, cfg, device="cpu")
    tokens = torch.tensor([[3, 250, 7, 42, 1, 99, 100, 17]])
    with torch.no_grad():
        ours = tllama.apply(params, tokens, cfg)
        theirs = model(tokens).logits
    np.testing.assert_allclose(ours.numpy(), theirs.numpy(), atol=ATOL,
                               rtol=RTOL)


def test_load_hf_refuses(dirs, tmp_path, monkeypatch):
    path = dirs["untied"]
    wrong = tllama.config_from_hf(path, d_ff=96)
    with pytest.raises(ValueError, match="shape mismatch"):
        tllama.load_hf(path, wrong, device="cpu")
    with pytest.raises(ValueError, match="A6"):
        tllama.load_hf(path, device="cpu", mesh=object())
    with pytest.raises(FileNotFoundError):
        tllama.load_hf(str(tmp_path), tllama.config_from_hf(path),
                       device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.load_hf(path)


def test_load_hf_without_the_safetensors_package(dirs):
    """The port reads the files with its own reader: a process where
    `safetensors` cannot be imported loads the sharded directory."""
    code = (
        "import sys\n"
        "sys.modules['safetensors'] = None\n"
        "from kubeflow_tpu_torch.models import llama\n"
        f"params, cfg = llama.load_hf({dirs['sharded-bf16']!r}, "
        "device='cpu')\n"
        "assert params['layers']['wq'].shape == (2, 64, 64)\n"
        "assert 'safetensors' not in [m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None]\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

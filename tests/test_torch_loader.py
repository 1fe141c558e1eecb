"""The port's token-corpus loaders (training/loader.py over its copy of
the C++ ring loader) and array_file data against the JAX package: the
native loader and the Python twin give JAX's PyTokenLoader batches byte
for byte, and JAX's NativeTokenLoader's where g++ is present; array_file
gives JAX's array_dataset batches; the errors are JAX's; and where JAX
falls back to the twin without a compiler, the port raises."""

from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

from kubeflow_tpu.training import data as jdata
from kubeflow_tpu.training import loader as jloader
from kubeflow_tpu_torch import native
from kubeflow_tpu_torch.training import data as tdata
from kubeflow_tpu_torch.training import loader as tloader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def corpus(tmp_path):
    path = str(tmp_path / "corpus.bin")
    tokens = np.random.default_rng(3).integers(0, 2 ** 32, 20_000,
                                               dtype=np.uint64)
    tloader.write_corpus(path, tokens.astype(np.uint32))
    return path


def _take(it, n):
    try:
        return [next(it)["tokens"] for _ in range(n)]
    finally:
        it.close()


@pytest.mark.parametrize("batch,seq,seed", [(4, 64, 0), (3, 17, 7),
                                            (1, 4096, 2 ** 63 + 5)])
def test_loaders_give_the_jax_batches(corpus, batch, seq, seed):
    want = _take(jloader.PyTokenLoader(corpus, batch, seq, seed), 6)
    got = {"native": _take(tloader.NativeTokenLoader(corpus, batch, seq,
                                                     seed), 6),
           "python": _take(tloader.PyTokenLoader(corpus, batch, seq,
                                                 seed), 6)}
    if shutil.which("g++") or shutil.which("c++"):
        got["jax native"] = _take(jloader.NativeTokenLoader(
            corpus, batch, seq, seed), 6)
    for name, batches in got.items():
        for w, g in zip(want, batches):
            assert g.dtype == w.dtype == np.int32, name
            assert g.shape == (batch, seq), name
            assert g.tobytes() == w.tobytes(), name


def test_token_file_dataset_picks_the_loader(corpus):
    nat = tloader.token_file_dataset(corpus, 2, 8, seed=1)
    py = tloader.token_file_dataset(corpus, 2, 8, seed=1,
                                    prefer_native=False)
    assert isinstance(nat, tloader.NativeTokenLoader)
    assert isinstance(py, tloader.PyTokenLoader)
    assert nat.corpus_tokens == 20_000
    a, b = next(nat), next(py)
    assert a["tokens"].tobytes() == b["tokens"].tobytes()
    assert nat.batches_produced >= 1
    nat.close()
    with pytest.raises(StopIteration):
        next(nat)


def test_prefer_native_raises_without_a_compiler(corpus, monkeypatch,
                                                 tmp_path):
    """No silent fallback: without a compiler (and no built library) the
    native loader raises, where JAX's token_file_dataset takes the twin."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    with pytest.raises(native.NativeUnavailable, match="compiler"):
        tloader.token_file_dataset(corpus, 2, 8)
    with pytest.raises(native.NativeUnavailable, match="compiler"):
        tdata.make_dataset(tdata.DatasetConfig(type="token_file",
                                               path=corpus, seq_len=8),
                           "llama", None, 2)
    py = tloader.token_file_dataset(corpus, 2, 8, prefer_native=False)
    assert isinstance(py, tloader.PyTokenLoader)


@pytest.mark.parametrize("shuffle", [True, False])
def test_array_file_gives_the_jax_batches(tmp_path, shuffle):
    path = str(tmp_path / "d.npz")
    rng = np.random.default_rng(0)
    np.savez(path, image=rng.standard_normal((11, 4, 4, 1), np.float32),
             label=np.arange(11, dtype=np.int32))
    ds = dict(type="array_file", path=path, shuffle=shuffle)
    t_it = tdata.make_dataset(tdata.DatasetConfig(**ds), "mnist_cnn", None,
                              4, fallback_seed=9)
    j_it = jdata.make_dataset(jdata.DatasetConfig(**ds), "mnist_cnn", None,
                              4, fallback_seed=9)
    for _ in range(7):   # past two epochs of 2 full batches
        a, b = next(t_it), next(j_it)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()
    arrays = {"x": np.arange(10)}
    for kw in (dict(shuffle=False, drop_remainder=False),
               dict(shuffle=True, seed=4)):
        t_ds = tdata.array_dataset(arrays, 3, **kw)
        j_ds = jdata.array_dataset(arrays, 3, **kw)
        for _ in range(9):
            assert next(t_ds)["x"].tolist() == next(j_ds)["x"].tolist()


def _error(fn):
    try:
        fn()
    except Exception as e:   # the JAX and port errors are compared
        return type(e), str(e)
    raise AssertionError("no error")


def test_errors_match_jax(tmp_path):
    short = str(tmp_path / "short.bin")
    tloader.write_corpus(short, np.arange(8, dtype=np.uint32))
    missing = str(tmp_path / "missing.bin")
    for ds in (dict(type="token_file"), dict(type="array_file"),
               dict(type="parquet")):
        assert _error(lambda: tdata.make_dataset(
            tdata.DatasetConfig(**ds), "llama", None, 4)) == _error(
            lambda: jdata.make_dataset(jdata.DatasetConfig(**ds), "llama",
                                       None, 4))
    for args in ((short, 2, 16), (missing, 2, 4)):
        assert _error(lambda: tloader.NativeTokenLoader(*args)) == _error(
            lambda: jloader.NativeTokenLoader(*args))
        assert _error(lambda: tloader.PyTokenLoader(*args)) == _error(
            lambda: jloader.PyTokenLoader(*args))


def test_the_port_builds_its_own_copy_of_the_loader():
    """The library is built from kubeflow_tpu_torch/native/data_loader.cpp
    under the port's build root, and its code (everything past the
    header comment) is the JAX package's native/src/data_loader.cpp."""
    lib = native.build("data_loader")
    assert lib.is_relative_to(native.BUILD_ROOT)
    mine = (native.SRC_DIR / "data_loader.cpp").read_text()
    with open(os.path.join(ROOT, "native", "src", "data_loader.cpp")) as f:
        theirs = f.read()
    body = mine[mine.index("#include"):]
    assert body == theirs[theirs.index("#include"):]

"""The port's example scripts (``examples/torch/*.py``), each run in process
through ``main([..., "--device", "cpu"])`` at its smallest size, the mesh
scripts at world size 1 (no ``torchrun``: no process group is made), each
under ``tests/torch_time_limit.py``.

Against the reference: each script's data (the synthetic MNIST, CIFAR,
Higgs and masked-LM sets, the char-LM corpus windows) is the reference
script's, array for array (tolerance 0: the same numpy draws), and each run
meets its bar: finite losses that fall, accuracy above chance where the
task is learnable at that size, the streamed and committed counts exact.
The ring attention of ``long_context.py`` at world size 1 equals dense
attention over the whole sequence within 1e-5 (float32).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from torch_time_limit import time_limited

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["mnist", "workflow", "cifar10", "bert_mlm", "resnet_imagenet",
           "streaming_inference", "char_lm", "pipeline_gpt", "real_data_digits",
           "long_context"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name):
    return _load(os.path.join(REPO, "examples", "torch", f"{name}.py"), f"port_example_{name}")


def ref(name):
    return _load(os.path.join(REPO, "examples", f"{name}.py"), f"ref_example_{name}")


def test_every_reference_script_has_a_port():
    want = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                  if f.endswith(".py"))
    assert sorted(SCRIPTS) == want
    readme = open(os.path.join(REPO, "examples", "torch", "README.md")).read()
    assert all(f"`{s}.py`" in readme for s in SCRIPTS)


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_parses_device_flag_and_imports_no_reference(name):
    src = open(os.path.join(REPO, "examples", "torch", f"{name}.py")).read()
    assert '"--device", default="cuda"' in src and "def main(argv=None)" in src
    for line in src.splitlines():
        words = line.split()
        if len(words) >= 2 and words[0] in ("import", "from"):
            assert words[1].split(".")[0] not in ("distkeras_tpu", "jax", "flax"), line


def _cols_equal(got, want):
    assert got.columns == want.columns
    for c in want.columns:
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("name,fn,kw", [
    ("mnist", "load_mnist", {"n": 64}), ("cifar10", "load_cifar", {"npz": None, "n": 16}),
    ("workflow", "load_higgs", {"csv": None, "n": 64}),
    ("bert_mlm", "make_mlm_data", {"n": 16, "seq": 8, "vocab": 32})])
def test_data_equals_the_reference_scripts(name, fn, kw):
    _cols_equal(getattr(port(name), fn)(**kw), getattr(ref(name), fn)(**kw))


def test_workflow_reads_the_bundled_csv_as_the_reference_does():
    p, r = port("workflow"), ref("workflow")
    _cols_equal(p.load_higgs(p.CSV), r.load_higgs(p.CSV))


def test_char_lm_corpus_equals_the_reference():
    ids, stoi, chars = port("char_lm").load_corpus()
    rids, rstoi, rchars = ref("char_lm").load_corpus()
    np.testing.assert_array_equal(ids, rids)
    assert stoi == rstoi and chars == rchars


@time_limited(timeout=120)
def test_mnist():
    out = port("mnist").main(["--device", "cpu", "--rows", "512", "--epochs", "1"])
    assert out["steps"] == 7 and out["accuracy"] > 0.5


@time_limited(timeout=120)
def test_mnist_async():
    out = port("mnist").main(["--device", "cpu", "--rows", "512", "--epochs", "1",
                              "--trainer", "adag", "--batch-size", "32"])
    assert out["steps"] > 0 and out["accuracy"] > 0.1


@time_limited(timeout=120)
def test_workflow_bundled_csv_sparse():
    out = port("workflow").main(["--device", "cpu", "--epochs", "2", "--trainers",
                                 "single,adag", "--sparse"])
    assert set(out) == {"single", "adag"}
    assert all(0.0 <= a <= 1.0 for a in out.values())


@time_limited(timeout=120)
def test_cifar10():
    out = port("cifar10").main(["--device", "cpu", "--rows", "256", "--epochs", "1",
                                "--batch-size", "32"])
    assert out["commits"] > 0 and 0.0 <= out["accuracy"] <= 1.0


@pytest.mark.parametrize("mode", ["sync", "dynsgd"])
@time_limited(timeout=120)
def test_bert_mlm(mode):
    out = port("bert_mlm").main(["--device", "cpu", "--mode", mode, "--rows", "64",
                                 "--seq", "16", "--vocab", "64"])
    assert out["steps"] == 8 and np.isfinite(out["last"])
    if mode == "sync":
        assert out["last"] < out["first"]
    else:
        # Each DynSGD worker's loss falls over its own steps; the history's
        # first and last rows belong to different workers and batches.
        assert sorted(out["workers"]) == [0, 1]
        assert all(np.isfinite(last) and last < first
                   for first, last in out["workers"].values()), out["workers"]


@time_limited(timeout=120)
def test_resnet_imagenet():
    out = port("resnet_imagenet").main(["--device", "cpu", "--image-size", "32",
                                        "--classes", "10", "--steps", "1",
                                        "--batch-size", "4"])
    assert out["steps"] == 2 and out["commits"] > 0


def test_resnet_imagenet_grpc_without_grpcio(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(ImportError, match="grpcio"):
        port("resnet_imagenet").main(["--device", "cpu", "--image-size", "32",
                                      "--classes", "10", "--steps", "1", "--batch-size",
                                      "4", "--transport", "grpc"])


@time_limited(timeout=120)
def test_streaming_inference():
    stats = port("streaming_inference").main(["--device", "cpu", "--batches", "3",
                                              "--batch-size", "16", "--rows", "256"])
    assert stats["batches"] == 3 and stats["rows"] == 48


@time_limited(timeout=120)
def test_char_lm():
    out = port("char_lm").main(["--device", "cpu", "--epochs", "1", "--max-chars", "4000",
                                "--sample", "8"])
    assert out["last"] < out["first"] and out["sample"].startswith("The reference ")
    assert len(out["sample"]) == len("The reference ") + 8


@pytest.mark.parametrize("extra", [[], ["--schedule", "1f1b", "--moe-experts", "2"]],
                         ids=["gpipe_v2", "1f1b_moe"])
@time_limited(timeout=120)
def test_pipeline_gpt(extra):
    out = port("pipeline_gpt").main(["--device", "cpu", "--epochs", "1", "--rows", "64",
                                     "--batch-size", "16", *extra])
    assert out["steps"] == 4 and out["last"] < out["first"]
    assert 0.0 <= out["greedy_accuracy"] <= 1.0


@time_limited(timeout=120)
def test_real_data_digits():
    out = port("real_data_digits").main(["--device", "cpu", "--epochs", "2",
                                         "--trainers", "single,adag"])
    assert out["single"] > 0.5 and set(out) == {"single", "adag"}


@pytest.mark.parametrize("flags", [[], ["--causal"], ["--flash", "--causal", "--stripe"],
                                   ["--ulysses", "--causal"]],
                         ids=["ring", "ring_causal", "flash_stripe", "ulysses"])
@time_limited(timeout=60)
def test_long_context_equals_dense_attention(flags):
    from distkeras_tpu_torch.ops.attention import dot_product_attention

    out = port("long_context").main(["--device", "cpu", "--seq", "64", "--heads", "2",
                                     "--dim", "16", *flags])
    assert out["finite"] and out["shape"] == (1, 64, 2, 16)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 64, 2, 16)).astype(np.float32))
               for _ in range(3))
    want = dot_product_attention(q, k, v, causal="--causal" in flags)
    np.testing.assert_allclose(out["out"].numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_scripts_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port("streaming_inference").main(["--batches", "1", "--rows", "128"])

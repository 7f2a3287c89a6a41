"""The port's command line, ``python -m distkeras_tpu_torch.run``.

- ``train`` in process on the CPU (``--device cpu``): the summary line, a
  provenance-stamped ``--out`` that the reference loads, the statusz file
  and the ``statusz`` page; an unknown model fails typed.
- ``serve`` as a child: the banner line carries every key of the
  reference's banner, and the host and port that ``ProcessReplica``
  reads; ``debugz`` and ``queryz`` render the live server's pages; SIGINT
  drains and prints the summary line.
- The shared replica-flag helper forwards the serving configuration and
  ``--device`` to every child; every parent parser takes those flags.
- The refusals: ``--mesh``, ``--mesh-shape``, ``--force-host-devices`` and
  ``--pipeline-depth 2`` on ``serve``, ``cluster`` and ``deploy`` exit
  with one line naming ROADMAP item A10, and ``--device cuda`` without a
  card exits naming the missing device.
"""

import argparse
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def job(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(256, 28)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    data = tmp_path / "d.npz"
    np.savez(data, features=x, label=y)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({
        "trainer": "DOWNPOUR", "worker_optimizer": "adam", "learning_rate": 0.01,
        "num_workers": 2, "batch_size": 16, "num_epoch": 2, "communication_window": 4,
    }))
    return data, cfg, tmp_path


def test_cli_train_statusz_and_stamped_out(job, capsys):
    data, cfg, tmp = job
    out, statusz = tmp / "weights.bin", tmp / "statusz.json"
    rc = run.main(["train", "--device", "cpu", "--config", str(cfg), "--data", str(data),
                   "--model", "higgs_mlp", "--out", str(out), "--statusz-out", str(statusz),
                   "--statusz-interval", "0.2"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["trainer"] == "DOWNPOUR" and summary["steps"] > 0
    assert summary["statusz"] == str(statusz) and "staleness_p99" in summary
    payload = json.loads(statusz.read_text())
    assert {w["worker"] for w in payload["workers"]} == {0, 1}
    from distkeras_tpu.checkpoint import load_weights_meta as ref_meta

    assert ref_meta(str(out))["version"] == 1  # the reference reads the stamp
    assert run.main(["statusz", "--file", str(statusz)]) == 0
    page = capsys.readouterr().out
    assert "workers:" in page and "staleness:" in page


def test_cli_unknown_model(job):
    data, cfg, _ = job
    with pytest.raises(SystemExit, match="unknown model"):
        run.main(["--device", "cpu", "--config", str(cfg), "--data", str(data),
                  "--model", "nope"])


def _base_args(**kw):
    base = dict(top_k=None, prefill_chunk=None, prefix_cache_mb=0.0, prefix_block=16,
                paged=False, kv_pool_mb=0.0, kv_block_tokens=16, max_context=None,
                draft_model=None, draft_args="{}", draft_weights=None, spec_k=4)
    base.update(kw)
    return argparse.Namespace(**base)


def test_serving_config_flags_forwarded_to_replicas():
    args = _base_args(top_k=8, prefill_chunk=32, paged=True, kv_pool_mb=64.0,
                      kv_block_tokens=8, max_context=48, draft_model="gpt_tiny",
                      draft_args='{"seq_len": 64}', spec_k=6, kv_host_tier_mb=8.0,
                      kv_tier_watermark=0.7, kv_disk_tier_dir="/d", kv_disk_tier_mb=16.0,
                      device="cpu")
    joined = " ".join(run._serving_config_flags(args))
    for pair in ("--paged", "--kv-pool-mb 64.0", "--kv-block-tokens 8", "--prefill-chunk 32",
                 "--max-context 48", "--top-k 8", "--draft-model gpt_tiny",
                 '--draft-args {"seq_len": 64}', "--spec-k 6", "--kv-host-tier-mb 8.0",
                 "--kv-tier-watermark 0.7", "--kv-disk-tier-dir /d", "--kv-disk-tier-mb 16.0",
                 "--device cpu"):
        assert pair in joined, (pair, joined)
    plain = run._serving_config_flags(_base_args())
    assert "--paged" not in plain and "--draft-model" not in plain
    assert plain[-2:] == ["--device", "cuda"]  # children never fall back to the CPU
    assert "--mesh" not in plain and "--force-host-devices" not in plain


def test_parsers_accept_serving_config_and_device(capsys):
    for main_fn in (run.deploy_main, run.serve_main):
        with pytest.raises(SystemExit) as e:
            main_fn(["--help"])
        assert e.value.code == 0
        text = capsys.readouterr().out
        for flag in ("--draft-model", "--draft-args", "--spec-k", "--paged", "--kv-pool-mb",
                     "--kv-block-tokens", "--prefill-chunk", "--prefix-cache-mb",
                     "--max-context", "--mesh", "--mesh-shape", "--force-host-devices",
                     "--device"):
            assert flag in text, (main_fn.__name__, flag)


@pytest.mark.parametrize("argv", [["--mesh"], ["--mesh-shape", "tp=2"],
                                  ["--force-host-devices", "2"], ["--pipeline-depth", "2"]],
                         ids=["mesh", "mesh-shape", "force-host-devices", "pipeline-depth"])
@pytest.mark.parametrize("sub", ["serve", "cluster", "deploy"])
def test_multi_device_flags_refused_naming_a10(sub, argv, tmp_path):
    extra = ["--watch-dir", str(tmp_path)] if sub == "deploy" else []
    with pytest.raises(SystemExit) as e:
        run.main([sub, "--device", "cpu", "--port", "0", *extra, *argv])
    assert "item A10" in str(e.value), e.value


@pytest.mark.parametrize("sub", ["serve", "cluster", "deploy", "train"])
def test_device_cuda_without_a_card_exits(sub, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    argv = {"serve": ["serve", "--port", "0"], "cluster": ["cluster", "--port", "0"],
            "deploy": ["deploy", "--port", "0", "--watch-dir", str(tmp_path)],
            "train": ["--config", "c.json", "--data", "d.npz"]}[sub]
    with pytest.raises(SystemExit, match="no CUDA device"):
        run.main(argv)


def test_serve_banner_debugz_queryz_and_sigint(capsys):
    """``serve --device cpu`` as a child: its banner, then the debugz and
    queryz subcommands against it, then SIGINT's drain and summary."""
    from distkeras_tpu_torch.serving import ServingClient

    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.run", "serve", "--device", "cpu",
         "--port", "0", "--model", "gpt_tiny", "--model-args",
         '{"seq_len": 32, "vocab_size": 64}', "--slots", "2", "--paged",
         "--kv-pool-mb", "2", "--kv-block-tokens", "4", "--request-trace", "16"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        banner = json.loads(line)
        ref_keys = {"serving", "host", "port", "slots", "max_queue", "prefill_chunk",
                    "prefix_cache_mb", "kv_pool_mb", "kv_pool_blocks", "draft_model",
                    "spec_k", "mesh"}
        assert ref_keys <= set(banner) and banner["device"] == "cpu"
        # What either package's ProcessReplica reads of it.
        assert banner.get("host") == "127.0.0.1" and int(banner["port"]) > 0
        port = str(banner["port"])

        import asyncio

        async def one():
            async with ServingClient("127.0.0.1", int(port)) as c:
                return await c.generate([1, 2, 3, 4, 5], 3, trace_id="cli-trace")

        done = asyncio.run(one())
        assert len(done["tokens"]) == 3
        capsys.readouterr()
        assert run.main(["debugz", "--port", port]) == 0
        page = capsys.readouterr().out
        assert "slots:" in page and "kv_pool:" in page
        assert run.main(["debugz", "--port", port, "--trace", "cli-trace"]) == 0
        assert "cli-trace" in capsys.readouterr().out
        assert run.main(["queryz", "--port", port, "--group-by", "kind", "--agg", "count"]) == 0
        assert "generate" in capsys.readouterr().out
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    summary = json.loads(out.strip().splitlines()[-1])
    assert "kv_pool" in summary

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
- The mesh flags (``--mesh``, ``--mesh-shape``, ``--force-host-devices``,
  ``--pipeline-depth 2``) on ``serve``, ``cluster`` and ``deploy`` are
  validated in the parent and a bad combination exits with one typed line
  before anything is built; ``cluster`` and ``deploy`` forward them to
  their replicas; ``serve --mesh-shape tp=2 --force-host-devices 2
  --device cpu`` as a child answers a client from two ranks; ``--device
  cuda`` without a card exits naming the missing device.
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


@pytest.mark.parametrize("argv,says", [
    (["--mesh", "--pipeline-depth", "2"], "needs a pp>=2 serving mesh"),
    (["--mesh-shape", "tp=2"], "needs 2 devices but 1 are visible"),
    (["--force-host-devices", "2"], "needs --mesh or --mesh-shape"),
    (["--pipeline-depth", "2"], "needs a pp>=2 serving mesh"),
], ids=["mesh", "mesh-shape", "force-host-devices", "pipeline-depth"])
@pytest.mark.parametrize("sub", ["serve", "cluster", "deploy"])
def test_multi_device_flags_refused_naming_a10(sub, argv, says, tmp_path):
    """The mesh flags are ported (A10e); what cannot run is a typed exit
    from the parent, before any rank or replica starts."""
    extra = ["--watch-dir", str(tmp_path)] if sub == "deploy" else []
    with pytest.raises(SystemExit) as e:
        run.main([sub, "--device", "cpu", "--port", "0", *extra, *argv])
    assert says in str(e.value), e.value


def test_force_host_devices_needs_device_cpu_and_flags_forwarded():
    with pytest.raises(SystemExit, match="needs --device cpu"):
        run.main(["serve", "--device", "cuda", "--port", "0", "--mesh",
                  "--force-host-devices", "2"])
    with pytest.raises(SystemExit, match="does not shard over tp=3"):
        run.main(["serve", "--device", "cpu", "--port", "0", "--mesh-shape", "tp=3",
                  "--force-host-devices", "3"])
    args = _base_args(mesh_shape="tp=2,pp=2", force_host_devices=4, device="cpu")
    joined = " ".join(run._serving_config_flags(args))
    assert "--mesh-shape tp=2,pp=2" in joined and "--force-host-devices 4" in joined


def test_serve_mesh_e2e_child_process():
    """``serve --mesh-shape tp=2 --force-host-devices 2 --device cpu``: the
    parent is rank 0 and binds the port, a second rank follows; a client's
    greedy tokens equal one rank's engine's, healthz carries the mesh row,
    and SIGINT ends both ranks (reference
    ``test_serve_mesh_e2e_child_process``)."""
    import asyncio

    from distkeras_tpu_torch.serving import ServingClient, ServingEngine

    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    model_args = '{"seq_len": 32, "vocab_size": 64}'
    proc = subprocess.Popen(
        [sys.executable, "-m", "distkeras_tpu_torch.run", "serve", "--device", "cpu",
         "--port", "0", "--model", "gpt_tiny", "--model-args", model_args, "--slots", "2",
         "--mesh-shape", "tp=2", "--force-host-devices", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    prompt = [1, 2, 3, 4, 5]
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["mesh"] == {"tp": 2} and banner["device"] == "cpu"

        async def one():
            async with ServingClient("127.0.0.1", int(banner["port"])) as c:
                done = await c.generate(prompt, 4)
                return done, await c.healthz()

        done, health = asyncio.run(one())
        assert health["mesh"]["axes"] == {"tp": 2} and len(health["mesh"]["devices"]) == 2
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    model = run.load_model("gpt_tiny", json.loads(model_args))
    engine = ServingEngine(model, model.init(0, device="cpu"), slots=2, device="cpu")

    async def alone():
        task = asyncio.create_task(engine.run())
        try:
            return await engine.submit(prompt, 4).result()
        finally:
            engine.shutdown()
            await task

    assert done["tokens"] == asyncio.run(alone())


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

"""Continuous deployment (``deploy/``) on the port.

- The publish-directory contract of the port's ``publish_weights`` /
  ``read_manifest`` / ``WeightPublisher`` (the reference's cases), and a
  weight file the port publishes loading in the reference with its stamp.
- A ``DeployController`` (``deploy/harness.py wire_controller``) over a
  two-replica ``LocalReplica`` fleet of port engines, each booted from a
  published file under an armed auditor: a good publish canaries and rolls,
  every replica then serves the new ``(version, digest)`` and the greedy
  tokens of the reference's ``generate()`` on those weights; a NaN publish
  fails the canary's golden-batch loss (the port's ``Model.apply`` and plain
  cross-entropy) and is quarantined while the fleet stays on last-good; a
  shape mismatch fails validation, by the port's flattened parameter names,
  before any replica is drained.
- The trainers' publisher hook: ``SingleTrainer`` publishes on its step
  cadence.

Every fleet test runs under ``time_limited``.
"""

import asyncio
import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.checkpoint import load_weights_file_with_provenance as ref_load
from distkeras_tpu.checkpoint import weights_provenance as ref_provenance
from distkeras_tpu.inference.generate import generate as ref_generate
from distkeras_tpu_torch import Dataset, SingleTrainer
from distkeras_tpu_torch.checkpoint import (
    load_weights_file_with_provenance,
    publish_weights,
    read_manifest,
    weights_provenance,
)
from distkeras_tpu_torch.deploy import PublishPolicy, WeightPublisher, parse_publish_every
from distkeras_tpu_torch.deploy.harness import make_golden_prompts, make_score_fn, wire_controller
from distkeras_tpu_torch.models import bert as port_bert
from distkeras_tpu_torch.models.mlp import higgs_mlp
from distkeras_tpu_torch.serving import LocalReplica, ServingClient, ServingCluster, ServingEngine
from distkeras_tpu_torch.serving.debugz import format_deployz
from distkeras_tpu_torch.telemetry.recompile import RecompileAuditor
from distkeras_tpu_torch.telemetry.registry import MetricsRegistry
from distkeras_tpu_torch.utils.bridge import params_from_jax, params_to_jax
from tests.test_torch_serving_engine import VOCAB, _pair, _prompts
from tests.torch_time_limit import time_limited

SUP = dict(health_interval_s=0.05, health_timeout_s=5.0, fail_after=4,
           base_delay_s=0.05, max_delay_s=1.0, stable_after_s=0.5)


@pytest.fixture(scope="module")
def lm():
    return _pair()


def test_publish_dir_contract_and_reference_reads_port_publish(lm, tmp_path):
    _, _, port, params = lm
    d = str(tmp_path / "pub")
    tree = params_to_jax(params, port.module)
    m1 = publish_weights(d, tree, meta={"step": 10, "loss": 0.5})
    assert m1["version"] == 1 and m1["digest"]
    got = read_manifest(d)
    assert got["version"] == 1 and got["step"] == 10 and got["loss"] == 0.5
    assert os.path.isabs(got["path"]) and os.path.exists(got["path"])
    prov = weights_provenance(got["path"])
    assert prov["version"] == 1 and prov["digest"] == m1["digest"]
    # The reference reads the port's publish: same stamp, same arrays.
    ref_tree, ref_prov = ref_load(got["path"])
    assert (ref_prov["version"], ref_prov["digest"]) == (1, m1["digest"])
    assert ref_provenance(got["path"])["digest"] == m1["digest"]
    back = params_from_jax(jax.tree.map(np.asarray, ref_tree), device="cpu")
    assert set(back) == set(params)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
    small = {"params": {"w": np.ones((3, 2), np.float32)}}
    for _ in range(5):
        publish_weights(d, small, keep=3)
    names = sorted(n for n in os.listdir(d) if n.startswith("weights-v"))
    assert len(names) == 3 and os.path.basename(read_manifest(d)["path"]) == names[-1]
    (tmp_path / "pub" / "MANIFEST.json").write_text("{not json")
    assert read_manifest(d) is None
    assert parse_publish_every("2.5s").every_seconds == 2.5
    assert parse_publish_every("40").every_steps == 40
    with pytest.raises(ValueError):
        parse_publish_every("0")
    pub = WeightPublisher(str(tmp_path / "gated"),
                          PublishPolicy(every_steps=1, min_improvement=0.1))
    assert pub.maybe_publish(lambda: small, step=0, loss_fn=lambda: 1.0)
    assert pub.maybe_publish(lambda: small, step=1, loss_fn=lambda: 0.99) is None
    assert pub.maybe_publish(lambda: small, step=2, loss_fn=lambda: 0.8)
    assert pub.published == 2


def test_golden_set_and_score_fn(lm):
    _, _, port, params = lm
    golden = make_golden_prompts(VOCAB, count=3, length=5, seed=0)
    assert golden == make_golden_prompts(VOCAB, count=3, length=5, seed=0)
    assert len(golden) == 3 and all(len(p) == 5 for p in golden)
    score = make_score_fn(port, VOCAB, device="cpu", warmup=params)
    flat = score(params)
    assert np.isfinite(flat)
    assert score(params_to_jax(params, port.module)) == pytest.approx(flat, rel=1e-6)
    assert not np.isfinite(score({k: v * float("nan") for k, v in params.items()}))
    if not torch.cuda.is_available():  # no fallback: the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_score_fn(port, VOCAB)


def _fleet(lm, boot_path, engines):
    _, _, port, _ = lm

    def factory(i):
        def build():
            tree, prov = load_weights_file_with_provenance(boot_path)
            eng = ServingEngine(port, params_from_jax(tree, device="cpu"), slots=2,
                                max_queue=16, auditor=RecompileAuditor(),
                                arm_auditor_after_warmup=True, weight_version=prov,
                                device="cpu")
            engines[i] = eng
            return eng

        return LocalReplica(build)

    return ServingCluster(factory, 2, supervisor_kwargs=SUP, registry=MetricsRegistry())


async def _publish(d, tree, **meta):
    return await asyncio.to_thread(publish_weights, d, tree, meta=meta or None)


def _seed_tree(port, seed):
    return params_to_jax(port.init(seed, device="cpu"), port.module)


def _deploy_run(lm, d, boot, steps):
    """Boot a fleet from ``boot``, wire a controller, run ``steps`` (an
    async callable of (ctrl, cluster)), and return its result with the
    fleet's deployz page and the engines' decode signatures."""
    _, _, port, _ = lm

    async def go():
        engines = {}
        cluster = _fleet(lm, boot["path"], engines)
        async with cluster:
            ctrl = wire_controller(cluster.router, d, model=port, vocab=VOCAB,
                                   golden_count=2, golden_len=6, seed=0,
                                   registry=cluster.router.registry, device="cpu",
                                   initial_weights=boot["path"])
            out = await steps(ctrl, cluster)
            async with ServingClient("127.0.0.1", cluster.port) as c:
                dz = await c.deployz()
            audits = {i: (e.auditor.compiles("serving_decode"),
                          e.auditor.report()["serving_decode"]["armed"])
                      for i, e in engines.items()}
        return out, dz, audits

    return asyncio.run(go())


@time_limited(timeout=180)
def test_good_publish_deploys_across_two_replicas(lm, tmp_path):
    ref, _, port, params = lm
    d = str(tmp_path / "pub")
    boot = publish_weights(d, params_to_jax(params, port.module), meta={"step": 0})
    prompt = _prompts(90, (6,))[0]
    new_tree = _seed_tree(port, 1)
    want = np.asarray(ref_generate(ref, jax.tree.map(np.asarray, new_tree),
                                   np.asarray([prompt], np.int32), 4,
                                   greedy=True))[0].tolist()

    async def steps(ctrl, cluster):
        async with ServingClient("127.0.0.1", cluster.port) as c:
            before = await c.generate(prompt, 4)
        await _publish(d, new_tree, step=100, loss=0.5)
        outcome = await ctrl.poll_once()
        served = []
        for _ in range(4):
            async with ServingClient("127.0.0.1", cluster.port) as c:
                served.append(await c.generate(prompt, 4))
        async with ServingClient("127.0.0.1", cluster.port) as c:
            health = await c.healthz()
        return before, outcome, served, health

    (before, outcome, served, health), dz, audits = _deploy_run(lm, d, boot, steps)
    new_prov = weights_provenance(read_manifest(d)["path"])
    assert before["weight_version"]["version"] == 1
    assert outcome["status"] == "deployed", outcome
    for done in served:
        assert done["tokens"] == want
        assert (done["weight_version"]["version"], done["weight_version"]["digest"]) == (
            new_prov["version"], new_prov["digest"])
    assert health["router"]["mixed_weight_versions"] is False
    assert dz["current"]["version"] == 2 and dz["counters"]["deploys"] == 1
    moved = dz["history"][-1]["replicas_moved"]
    assert set(moved) == {"r0", "r1"}
    assert all(mv["after"]["version"] == 2 for mv in moved.values())
    # One decode signature on every replica through boot, canary and roll
    # (a replica that only ran its swap's rewarm tick is not armed yet).
    assert all(c == 1 for c, _ in audits.values()) and any(a for _, a in audits.values())
    page = format_deployz(dz)
    assert "current:   v2" in page and "deploys=1" in page


@time_limited(timeout=180)
def test_nan_publish_quarantined_fleet_stays_on_last_good(lm, tmp_path):
    _, _, port, params = lm
    d = str(tmp_path / "pub")
    boot = publish_weights(d, params_to_jax(params, port.module))
    prompt = _prompts(91, (5,))[0]
    nan_tree = params_to_jax({k: v * float("nan") for k, v in port.init(3, device="cpu").items()},
                             port.module)

    async def steps(ctrl, cluster):
        await _publish(d, nan_tree)
        outcome = await ctrl.poll_once()
        async with ServingClient("127.0.0.1", cluster.port) as c:
            done = await c.generate(prompt, 4)
            health = await c.healthz()
        return outcome, done, health

    (outcome, done, health), dz, audits = _deploy_run(lm, d, boot, steps)
    assert outcome["status"] == "canary_rejected" and "not finite" in outcome["reason"]
    assert done["weight_version"]["version"] == 1
    assert np.isfinite(done["tokens"]).all() and len(done["tokens"]) == 4
    assert health["router"]["replicas_ready"] == 2
    assert list(health["router"]["weight_versions"].values()) == [2]
    assert {q["version"] for q in dz["quarantined"]} == {2}
    q = dz["quarantined"][0]
    assert os.path.exists(q["quarantined_to"])
    assert os.path.exists(q["quarantined_to"] + ".reason.json")
    assert dz["counters"]["canary_failures"] == 1 and dz["current"]["version"] == 1
    assert all(c <= 1 for c, _ in audits.values()), audits


@time_limited(timeout=180)
def test_shape_mismatch_fails_validation_before_any_replica(lm, tmp_path):
    _, _, port, params = lm
    d = str(tmp_path / "pub")
    boot = publish_weights(d, params_to_jax(params, port.module))
    wrong_model = port_bert.gpt_tiny(seq_len=32, vocab_size=32)
    wrong = params_to_jax(wrong_model.init(0, device="cpu"), wrong_model.module)

    async def steps(ctrl, cluster):
        await _publish(d, wrong)
        swaps = {rid: info.handle.engine.weight_version
                 for rid, info in cluster.replicas.items()}
        outcome = await ctrl.poll_once()
        after = {rid: info.handle.engine.weight_version
                 for rid, info in cluster.replicas.items()}
        return outcome, swaps, after

    (outcome, swaps, after), dz, _ = _deploy_run(lm, d, boot, steps)
    assert outcome["status"] == "validation_failed", outcome
    assert "candidate leaf" in outcome["reason"] and "(64" in outcome["reason"], outcome["reason"]
    assert "canary" not in outcome
    assert swaps == after
    assert dz["counters"]["validation_failures"] == 1


@time_limited
def test_step_trainer_publishes_on_cadence(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(96, 28)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    ds = Dataset.from_arrays(features=x, label=y)
    trainer = SingleTrainer(higgs_mlp(), worker_optimizer="adam", learning_rate=0.01,
                            batch_size=32, num_epoch=2, device="cpu")
    d = str(tmp_path / "pub")
    trainer.publisher = WeightPublisher(d, PublishPolicy(every_steps=2))
    trained = trainer.train(ds)
    # 6 steps, cadence 2, the first always due: steps 1, 3, 5.
    manifest = read_manifest(d)
    assert manifest["version"] == 3 and manifest["step"] == 5
    assert np.isfinite(manifest["loss"])
    tree, prov = ref_load(manifest["path"])
    assert prov["version"] == 3 and prov["digest"] == manifest["digest"]
    assert "params" in tree
    assert set(params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")) == set(
        trained.variables)

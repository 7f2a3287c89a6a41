"""One rank of the port's two-rank data-parallel runs on the CPU.

    python tests/torch_dp_worker.py WORKDIR RANK WORLD

``tests/test_torch_data_parallel.py`` starts WORLD of these. They join one
gloo process group through a file store in WORKDIR, read the scenarios'
inputs from ``WORKDIR/inputs.pkl`` (weights bridged from the reference's
init, and the data), run every scenario in order and write what each
produced to ``WORKDIR/result-RANK.pkl``. The worker imports the port and
torch only.
"""

import dataclasses
import os
import pickle
import sys
import traceback

import numpy as np
import torch

import distkeras_tpu_torch as dk
from distkeras_tpu_torch.models import bert
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.models.mlp import MLP
from distkeras_tpu_torch.models.resnet import resnet18
from distkeras_tpu_torch.parallel import distributed
from distkeras_tpu_torch.parallel.mesh import best_mesh, make_mesh


def bert_model(cfg: dict) -> Model:
    base = getattr(bert, cfg["name"])(seq_len=cfg["seq"], vocab_size=cfg["vocab"])
    return bert._make(dataclasses.replace(
        base.config, use_flash_attention=True, dtype=torch.float32, dropout_rate=0.0),
        cfg["seq"], cfg["name"])


def mlp_model(cfg: dict) -> Model:
    return Model(lambda: MLP(cfg["dim"], (32,), 2, compute_dtype=torch.float32),
                 input_shape=(cfg["dim"],), output_dim=2)


def resnet_model(cfg: dict) -> Model:
    return resnet18(cfg["classes"], cfg["size"], dtype=torch.float32)


MODELS = {"bert": bert_model, "mlp": mlp_model, "resnet": resnet_model}


def with_weights(model: Model, weights: dict) -> Model:
    """The model, its ``init`` returning ``weights`` (the reference's init,
    bridged) for any seed."""
    model.init = lambda seed=0, device=None: {k: torch.as_tensor(v).clone()
                                              for k, v in weights.items()}
    return model


def host(variables: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in variables.items()}


def train(case: dict, workdir: str) -> dict:
    model = with_weights(MODELS[case["model"]](case["config"]), case["weights"])
    data = dk.Dataset.from_arrays(**case["data"])
    kwargs = dict(case["kwargs"])
    if "checkpoint_dir" in kwargs:
        kwargs["checkpoint_dir"] = os.path.join(workdir, kwargs["checkpoint_dir"])
    trainer = dk.SynchronousDistributedTrainer(model, device="cpu", **kwargs)
    trained = trainer.train(data, shuffle=case.get("shuffle", False))
    out = {"history": trainer.history, "weights": host(trained.variables)}
    if "checkpoint_dir" in kwargs:
        out["saved_steps"] = sorted(int(n) for n in os.listdir(kwargs["checkpoint_dir"])
                                    if n.isdigit())
    return out


def predict(case: dict, workdir: str) -> dict:
    model = with_weights(MODELS[case["model"]](case["config"]), case["weights"])
    trained = TrainedModel(model, model.init())
    data = dk.Dataset.from_arrays(features=case["features"])
    out = {}
    for name, mesh in (("mesh", best_mesh()), ("plain", None)):
        pred = dk.ModelPredictor(trained, batch_size=case["batch_size"], mesh=mesh,
                                 device="cpu")
        out[name] = np.asarray(pred.predict(data)["prediction"])
    return out


def refuse(case: dict, workdir: str) -> dict:
    model = with_weights(MODELS[case["model"]](case["config"]), case["weights"])
    try:
        dk.SynchronousDistributedTrainer(model, device="cpu", **case["kwargs"]).train(
            dk.Dataset.from_arrays(**case["data"]))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def groups(case: dict, workdir: str) -> dict:
    """The groups of a dp=2, tp=1 mesh: dp the default group, tp this rank's
    own group of the mesh's ``DeviceMesh``; each axis's sum of rank + 1."""
    m = make_mesh({"dp": 2, "tp": 1})
    out = {"device_mesh": m.device_mesh.mesh.tolist()}
    for axis in m.axis_names:
        group = m.group(axis)
        t = torch.tensor([distributed.process_index() + 1.0])
        torch.distributed.all_reduce(t, group=group)
        out[axis] = [torch.distributed.get_world_size(group), t.item()]
    return out


RUNNERS = {"train": train, "predict": predict, "refuse": refuse, "groups": groups}


def main(workdir: str, rank: int, world: int) -> int:
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        scenarios = pickle.load(f)
    distributed.initialize(f"file://{os.path.join(workdir, 'store')}", world, rank,
                           backend="gloo")
    results = {"world": distributed.process_count(), "rank": distributed.process_index()}
    try:
        for name, case in scenarios.items():
            results[name] = RUNNERS[case["kind"]](case, workdir)
    except BaseException:
        results["failure"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(workdir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3])))

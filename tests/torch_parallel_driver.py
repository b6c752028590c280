"""Rank program of tests/test_torch_parallel.py and
tests/test_torch_multihost.py (not a test file), and ``launch``, which
starts it on a gloo process group of CPU processes.

    python tests/torch_parallel_driver.py OUT_DIR INPUTS.pkl CASE[@d,m] ...

Every rank of a gloo process group on the CPU runs it with the
``CC_COORD_ADDR`` / ``CC_NUM_PROCS`` / ``CC_PROC_ID`` variables (without
them it runs as one process, no process group). It runs the named cases
in order, each on a mesh of the given shape, on the inputs the test wrote
(numpy arrays), and writes its results to ``OUT_DIR/rank{R}.pkl``. It
imports nothing of JAX: the test holds the results to the JAX package.
"""

import os
import os.path as osp
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

from clip_calibration_tpu_torch.parallel import dryrun as D  # noqa: E402
from clip_calibration_tpu_torch.parallel import mesh as P  # noqa: E402

#: registered in this process for the tensor-parallel Predictor: the TP
#: tower's config (2 vision heads), weights in CLIP_CHECKPOINT_DIR
TP_PRESET = "ViT-TP-Test"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv, world, out_dir, env=None, timeout=300):
    """Run ``argv`` (after the python executable) as ``world`` ranks of a
    gloo process group on the CPU (``CC_*`` variables; one process and no
    cluster when world is 0), each in its own working directory
    ``out_dir/cwd{R}``; returns each rank's output, after asserting every
    rank exited 0 (a rank still running at the timeout is killed)."""
    port = free_port()
    procs = []
    for rank in range(max(world, 1)):
        penv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                    **(env or {}))
        penv.pop("CC_COORD_ADDR", None)
        if world:
            penv.update(CC_COORD_ADDR=f"localhost:{port}",
                        CC_NUM_PROCS=str(world), CC_PROC_ID=str(rank))
        cwd = osp.join(out_dir, f"cwd{rank}")
        os.makedirs(cwd, exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, *argv], cwd=cwd, env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    return logs


def run_ranks(out_dir, world, inputs, cases, weights, timeout=300):
    """This driver on ``world`` ranks (``launch``) over ``inputs``;
    returns each rank's results."""
    os.makedirs(out_dir, exist_ok=True)
    inputs_path = osp.join(out_dir, "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    launch([osp.abspath(__file__), out_dir, inputs_path, *cases], world,
           out_dir, {"CLIP_CHECKPOINT_DIR": weights}, timeout)
    out = []
    for rank in range(max(world, 1)):
        with open(osp.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def port_trainer(name, root, out_dir, overrides, mesh_shape, seed=1):
    """The port's trainer over the Synthetic data on ViT-Test at fp32, as
    tests/test_torch_training.py::_port_trainer builds it, on a mesh."""
    from clip_calibration_tpu_torch.config import get_cfg_default
    from clip_calibration_tpu_torch.data.base import set_random_seed
    from clip_calibration_tpu_torch.engine.registry import TRAINER_REGISTRY
    from clip_calibration_tpu_torch.ops.preprocess import (CLIP_PIXEL_MEAN,
                                                           CLIP_PIXEL_STD)
    import clip_calibration_tpu_torch.data.datasets  # noqa: F401
    import clip_calibration_tpu_torch.evaluators.vl_evaluator  # noqa: F401
    import clip_calibration_tpu_torch.trainers  # noqa: F401
    cfg = get_cfg_default()
    cfg.TEST.EVALUATOR = "VLClassification"
    cfg.DATASET.NAME = "Synthetic"
    cfg.DATASET.ROOT = str(root)
    cfg.SEED = seed
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.MODEL.BACKBONE.NAME = "ViT-Test"
    cfg.INPUT.SIZE = (32, 32)
    cfg.INPUT.PIXEL_MEAN = list(CLIP_PIXEL_MEAN)
    cfg.INPUT.PIXEL_STD = list(CLIP_PIXEL_STD)
    cfg.INPUT.TRANSFORMS = ("random_resized_crop", "random_flip",
                            "normalize")
    cfg.TRAINER.NAME = name
    if mesh_shape is not None:
        cfg.TPU.MESH_SHAPE = tuple(mesh_shape)
    for key, v in overrides.items():
        node = cfg
        *parts, last = key.split(".")
        for p in parts:
            node = getattr(node, p)
        setattr(node, last, v)
    set_random_seed(seed)
    return TRAINER_REGISTRY.get(name)(cfg, device="cpu")


def _host(t):
    return t.detach().float().cpu().numpy()


def case_shapes(inp, shape):
    from clip_calibration_tpu_torch.config import get_cfg_default
    out = {"default": P.make_mesh().dims}
    m = P.make_mesh(shape)
    out["shape"] = m.shape
    out["coords"] = (m.data_coord, m.model_coord)
    # the ranks of the groups the collectives run over
    out["groups"] = tuple(dist.get_process_group_ranks(g)
                          for g in (m.data_group, m.model_group))
    out["data_ranks"] = list(m.data_ranks)
    try:
        P.make_mesh((3, 2))
    except ValueError as e:
        out["bad"] = str(e)
    cfg = get_cfg_default()
    cfg.TPU.MESH_SHAPE = shape
    out["cfg"] = P.mesh_from_cfg(cfg).shape
    return out


def case_dryrun(inp, shape):
    res = D.dryrun_multichip("cpu", root=inp["rank_dir"])
    return {"coop_loss": res["coop_loss"],
            "coop_grad": res["coop_grad"],
            "eval_probs": res["eval_probs"],
            "tp": "tp" in res}


def case_coop_loss(inp, shape):
    """The dry run's CoOp loss and one SGD step on the test's inputs."""
    from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
    mesh = P.make_mesh(shape)
    model, cfg = load_clip_backbone("ViT-Test", "float32", "cpu")
    c = {k: torch.as_tensor(v) for k, v in inp["coop"].items()}
    loss, grad, _ = D.coop_step(c["ctx"], model, cfg, c["embedding"],
                                c["eot_pos"], c["images"], c["labels"],
                                int(inp["coop"]["n_ctx"]), mesh)
    return {"loss": float(loss), "grad": _host(grad)}


def case_trainer(inp, shape, name):
    """On the test's batch and trainables: one loss and its gradients (on
    the mesh and on one rank), the logits (ProDA's after
    ``set_classifier``), then one train step and the trainables after
    it."""
    from clip_calibration_tpu_torch.engine.checkpoint import (
        flatten_params, unflatten_params)
    spec = inp["trainers"][name]
    t = port_trainer(spec["trainer"], inp["data_root"],
                     osp.join(inp["rank_dir"], "out_" + name),
                     spec["overrides"], shape)
    slot = t.get_model_names()[0]
    t._set_params(slot, unflatten_params(
        {k: np.array(v) for k, v in spec["trainables"].items()}))
    mesh = t.mesh
    images = torch.as_tensor(spec["images"])
    labels = spec["labels"]
    extra = (spec["prompt_idx"],) if "prompt_idx" in spec else ()
    out = D.trainer_step_check(t, images, labels, *extra)
    with torch.no_grad():
        if hasattr(t, "set_classifier"):
            t.set_classifier()
            out["text_features"] = _host(t.text_features)
        logits, _, _ = t.model_inference(D.local_rows(images, mesh))
        out["logits"] = _host(P.gather_data(logits, mesh))
    batch = {"img": D.local_rows(spec["images"], mesh),
             "label": D.local_rows(labels, mesh)}
    if "prompt_idx" in spec:
        t._next_prompt_batch = lambda: spec["prompt_idx"]
    out["step_loss"] = float(t.forward_backward(batch)["loss"])
    out["trainables"] = {k: _host(v) for k, v in
                         flatten_params(t.model_params(slot)).items()}
    return out


def case_tp(inp, shape):
    from clip_calibration_tpu_torch.models.weights import params_from_numpy
    mesh = P.make_mesh(shape)
    model = params_from_numpy(inp["tp_params"], D.TP_CFG, torch.float32,
                              "cpu")
    out = D.tp_tower(mesh, "cpu", model=model,
                     images=torch.as_tensor(inp["tp_images"]))
    return {k: out[k] for k in ("image", "text")}  # (TP, whole tower)


def case_predictor(inp, shape):
    """``Predictor`` on the mesh (the ViT tower tensor-parallel over a
    model axis > 1) and ``TrainerPredictor`` over a CoCoOp trainer built
    on it; every rank returns the whole result."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.serving import (Predictor,
                                                    TrainerPredictor)
    M.PRESETS[TP_PRESET] = D.TP_CFG
    mesh = P.make_mesh(shape)
    pred = Predictor(TP_PRESET, inp["classnames"], precision="fp32",
                     batch_size=3, mesh=mesh, device="cpu")
    out = {"batch_size": pred.batch_size,
           "probs": pred.predict(inp["serve_images"])["probs"]}
    spec = inp["trainers"]["cocoop"]
    t = port_trainer("CoCoOp", inp["data_root"],
                     osp.join(inp["rank_dir"], "out_serve"),
                     spec["overrides"], shape)
    tp = TrainerPredictor(t, batch_size=3)
    out["trainer_batch_size"] = tp.batch_size
    out["trainer_probs"] = tp.predict(inp["trainer_images"])["probs"]
    return out


CASES = {
    "shapes": case_shapes,
    "dryrun": case_dryrun,
    "coop_loss": case_coop_loss,
    "dp_coop": lambda inp, s: case_trainer(inp, s, "dp_coop"),
    "cocoop": lambda inp, s: case_trainer(inp, s, "cocoop"),
    "proda": lambda inp, s: case_trainer(inp, s, "proda"),
    "tp": case_tp,
    "predictor": case_predictor,
    "products": lambda inp, s: D.product_trainers(
        P.make_mesh(s), "cpu", inp["rank_dir"], batch=inp["batch"]),
}


def main():
    out_dir, inputs_path, *cases = sys.argv[1:]
    torch.set_num_threads(1)
    if os.environ.get("CC_COORD_ADDR"):
        P.initialize_distributed(device="cpu")
    rank, n = P.world()
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    inp["rank_dir"] = osp.join(out_dir, f"rank{rank}")
    os.makedirs(inp["rank_dir"], exist_ok=True)
    results = {"world": n}
    for case in cases:
        name, _, shape = case.partition("@")
        shape = tuple(int(x) for x in shape.split(",")) if shape else ()
        results[case] = CASES[name](inp, shape)
    with open(osp.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    if n > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

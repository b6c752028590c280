"""Rank program of tests/test_torch_parallel.py and
tests/test_torch_multihost.py (not a test file), and ``launch``, which
starts it on a gloo process group of CPU processes.

    python tests/torch_parallel_driver.py OUT_DIR INPUTS.pkl CASE ...

(each CASE ``NAME[:KEY][@d,m]``). Every rank of a gloo process group on
the CPU runs it with the ``CC_COORD_ADDR`` / ``CC_NUM_PROCS`` /
``CC_PROC_ID`` variables (without them it runs as one process, no
process group). It runs the named cases in order, each on a mesh of the
given shape, on the inputs the test wrote (numpy arrays), and writes its
results to ``OUT_DIR/rank{R}.pkl``. It imports nothing of JAX: the test
holds the results to the JAX package.
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
    """The port's trainer over the Synthetic data on ViT-Test (fp32 or
    bf16, as ``overrides`` say), as
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


def case_step(inp, shape, key):
    """One loss and its gradients on the mesh and on one rank
    (``trainer_step_check``) of the test's trainer ``key`` on its batch
    and trainables, nothing else."""
    from clip_calibration_tpu_torch.engine.checkpoint import unflatten_params
    spec = inp["trainers"][key]
    t = port_trainer(spec["trainer"], inp["data_root"],
                     osp.join(inp["rank_dir"], "out_" + key),
                     spec["overrides"], shape)
    t._set_params(t.get_model_names()[0], unflatten_params(
        {k: np.array(v) for k, v in spec["trainables"].items()}))
    extra = (spec["prompt_idx"],) if "prompt_idx" in spec else ()
    return D.trainer_step_check(t, torch.as_tensor(spec["images"]),
                                spec["labels"], *extra)


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


#: the int8 modes of the TP towers: (qmode, static activation scales)
INT8_MODES = {"dequant": ("dequant", False), "w8a8_static": ("w8a8", True),
              "w8a8": ("w8a8", False), "w8a8_dynamic": ("w8a8_dynamic", True)}


def case_int8_tp(inp, shape):
    """The int8 TP towers in each of ``INT8_MODES``: this data rank's rows
    through the image tower and the raw-token text tower on one
    ``TowerTP``, gathered, beside the whole towers on one rank (static
    scales: the JAX package's, attached on every rank); the calibration
    statistics under TP and on one rank, of this data rank's rows."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.models.weights import params_from_numpy
    from clip_calibration_tpu_torch.ops import quant as Q
    from clip_calibration_tpu_torch.parallel.tp import tower_tp
    mesh = P.make_mesh(shape)
    tp = tower_tp(mesh)
    cfg = D.TP_CFG
    model = params_from_numpy(inp["tp_params"], cfg, torch.float32, "cpu")
    q = inp["int8_tp"]
    qm = Q.quantize_clip_params(model, towers=("visual", "text"))
    static = Q.attach_text_act_scales(
        Q.attach_act_scales(qm, q["image_stats"]), q["text_stats"])
    images = torch.as_tensor(inp["tp_images"])
    tokens = torch.as_tensor(q["tokens"])
    out = {}
    with torch.inference_mode():
        for name, (qmode, scaled) in INT8_MODES.items():
            m = static if scaled else qm
            for tower, x, fn in (
                    ("image", images, lambda x, tp_: M.encode_image(
                        m, cfg, x, dtype=torch.float32, qmode=qmode,
                        tp=tp_)),
                    ("text", tokens, lambda x, tp_: M.encode_text(
                        m, cfg, x, dtype=torch.float32, qmode=qmode,
                        tp=tp_))):
                got = P.gather_data(fn(D.local_rows(x, mesh), tp), mesh)
                out[f"{tower}/{name}"] = (_host(got), _host(fn(x, None)))
        # the slices of the blocks that carry the static scales carry them
        out["static_slices"] = all(
            tp.block(b)[k].act_scale is not None
            for b in static.visual.blocks for k in ("wqkv", "wo"))
        rows = D.local_rows(images, mesh)
        for key, tp_ in (("stats_tp", tp), ("stats_one", None)):
            _, stats = M.encode_image(qm, cfg, rows, dtype=torch.float32,
                                      collect_act_stats=True, tp=tp_)
            out[key] = Q.stats_to_numpy(stats)
    return out


def case_int8_predictor(inp, shape):
    """The TP ``Predictor`` with ``quantize`` in int8 and w8a8 (static
    scales calibrated on every rank, unsharded), on the serving images and
    on one image (the 1-row bucket)."""
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.serving import Predictor
    M.PRESETS[TP_PRESET] = D.TP_CFG
    mesh = P.make_mesh(shape)
    out = {}
    for quantize, kw in (("int8", {}), ("w8a8", {
            "calibration_images": inp["serve_images"][:4]})):
        pred = Predictor(TP_PRESET, inp["classnames"], precision="fp32",
                         batch_size=3, mesh=mesh, quantize=quantize,
                         device="cpu", **kw)
        out[quantize] = pred.predict(inp["serve_images"])["probs"]
        out[quantize + "_one"] = pred.predict(
            inp["serve_images"][:1])["probs"]
    return out


def case_mesh_predictor(inp, shape):
    """``parallel/http_mesh.py`` without HTTP: rank 0's ``MeshPredictor``
    rejects a wrong image size and takes an empty batch without a
    collective, then sends one batch after a pause filled by no-op
    headers, then the stop code; the other ranks ``follow``."""
    import time
    from clip_calibration_tpu_torch.models import clip as M
    from clip_calibration_tpu_torch.parallel import http_mesh
    from clip_calibration_tpu_torch.serving import Predictor
    M.PRESETS[TP_PRESET] = D.TP_CFG
    http_mesh.HEARTBEAT_S = 0.2
    pred = Predictor(TP_PRESET, inp["classnames"], precision="fp32",
                     batch_size=3, mesh=P.make_mesh(shape), device="cpu")
    if dist.get_rank() != 0:
        return {"joined": http_mesh.follow(pred, "cpu")}
    front = http_mesh.MeshPredictor(pred, "cpu")
    out = {}
    try:
        front.predict(np.zeros((2, 16, 16, 3), np.uint8))
    except ValueError as e:
        out["rejected"] = str(e)
    out["empty"] = front.predict(np.zeros((0, 32, 32, 3), np.uint8))
    time.sleep(1.0)
    out["probs"] = front.predict(inp["serve_images"])["probs"]
    front.stop()
    try:
        front.predict(inp["serve_images"])
    except RuntimeError as e:
        out["after_stop"] = str(e)
    return out


CASES = {
    "shapes": case_shapes,
    "dryrun": case_dryrun,
    "coop_loss": case_coop_loss,
    "dp_coop": lambda inp, s: case_trainer(inp, s, "dp_coop"),
    "cocoop": lambda inp, s: case_trainer(inp, s, "cocoop"),
    "proda": lambda inp, s: case_trainer(inp, s, "proda"),
    "step": case_step,  # step:KEY, KEY a trainer of the inputs
    "tp": case_tp,
    "predictor": case_predictor,
    "int8_tp": case_int8_tp,
    "int8_predictor": case_int8_predictor,
    "mesh_predictor": case_mesh_predictor,
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
        name, _, key = name.partition(":")
        results[case] = (CASES[name](inp, shape, key) if key
                         else CASES[name](inp, shape))
    with open(osp.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    if n > 1:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

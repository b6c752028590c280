"""Batch-serving CLI: images in, calibrated predictions out (one JSON
line per image), and the resident HTTP server.

The JAX package's ``serve.py`` argument surface plus ``--device``
(default ``cuda``; asking for it without a card raises):

    # zero-shot
    python -m clip_calibration_tpu_torch.serve --backbone ViT-B/16 \
        --classnames cat dog pelican --images ./photos --out preds.jsonl

    # a trainer checkpoint (ZeroshotCLIP, CoOp, TempScaling), dataset-free
    python -m clip_calibration_tpu_torch.serve --checkpoint-dir out/coop \
        --trainer CoOp --config-file configs/trainers/CoOp/...yaml \
        --classnames-file classes.txt --images ./photos

    # CoOp prompt checkpoint, int8 vision tower with calibrated static
    # activation scales (kernel K3 on the card), saved for later hosts
    python -m clip_calibration_tpu_torch.serve --checkpoint-dir out/coop \
        --coop-prompt --classnames-file classes.txt --images ./photos \
        --quantize w8a8 --calibration-images ./cal --save-act-scales s.npz

    # resident HTTP model server (dynamic micro-batching)
    python -m clip_calibration_tpu_torch.serve --http 0.0.0.0:8080 \
        --backbone ViT-B/16 --classnames-file classes.txt --quantize int8

On the CPU pass ``--device cpu`` (the kernels' plain versions run there).
Host-side geometry uses the eval transform (shorter-side bicubic +
center crop, ``data/transforms.py``; ``--config-file`` supplies the
training run's INPUT tree); ``--preprocess-on-device`` ships raw
uniform-size uint8 and resizes on the device instead
(``ops/preprocess.device_preprocess``, ``Predictor`` paths only).
``--mesh d[,m]`` serves over a process mesh (``parallel/mesh.py``):
every rank runs the same command with the ``CC_COORD_ADDR`` /
``CC_NUM_PROCS`` / ``CC_PROC_ID`` cluster variables (NCCL on cards, gloo
on ``--device cpu``); each data rank encodes its slice of every batch,
the ViT tower runs tensor-parallel over a model axis m > 1, and rank 0
writes ``--out``. For a trainer checkpoint the shape feeds
``TPU.MESH_SHAPE``. ``--http`` over a mesh serves on rank 0; the other
ranks build the same predictor and join each batch
(``parallel/http_mesh.py``). SIGTERM ends the server as Ctrl-C does, and
then every rank exits 0. TF32 stays off, as in the port's ``train.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m clip_calibration_tpu_torch.serve",
        description="Serve calibrated CLIP predictions over a directory "
                    "of images (no dataset directory needed)")
    p.add_argument("--images", default=None,
                   help="image file(s) or a directory (batch mode; "
                        "required unless --http)")
    p.add_argument("--http", default=None, metavar="HOST:PORT",
                   help="run as a resident HTTP model server instead "
                        "of batch-scoring --images (dynamic micro-"
                        "batching; see http_server.py). ':0' picks a "
                        "free port")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="HTTP mode: batching latency budget — a lone "
                        "request waits at most this long for "
                        "coalescing partners")
    p.add_argument("--out", default="-",
                   help="output JSONL path (default stdout)")
    p.add_argument("--backbone", default="ViT-B/16")
    p.add_argument("--classnames", nargs="*", default=None)
    p.add_argument("--classnames-file", default=None,
                   help="one classname per line")
    p.add_argument("--template", default="a photo of a {}.")
    p.add_argument("--checkpoint-dir", default=None,
                   help="trainer output dir (torch .pth.tar-N or npz)")
    p.add_argument("--coop-prompt", action="store_true",
                   help="treat --checkpoint-dir as a CoOp-family prompt "
                        "checkpoint (Predictor.from_prompt_checkpoint) "
                        "instead of a full trainer build")
    p.add_argument("--trainer", default=None,
                   help="registered trainer name for --checkpoint-dir")
    p.add_argument("--config-file", default=None,
                   help="training config yaml reproducing the checkpoint"
                        "'s hyperparameters")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--precision", default="bf16",
                   choices=("bf16", "fp32"))
    p.add_argument("--class-confidence", default=None,
                   help=".npy with per-class DAC confidences")
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--mesh", default=None,
                   help="process mesh shape, e.g. '2' (data-parallel) or "
                        "'1,2' (data, model: tensor-parallel ViT tower); "
                        "every rank runs the command with the CC_* "
                        "cluster variables")
    p.add_argument("--preprocess-on-device", action="store_true")
    p.add_argument("--quantize", default=None,
                   choices=["int8", "w8a8"],
                   help="int8 vision tower (ops/quant.py): 'int8' = "
                        "weight-only (half the HBM weight footprint/"
                        "bandwidth), 'w8a8' = full int8 matmuls (pair "
                        "with --calibration-images for the static-"
                        "scale configuration that beats bf16 at large "
                        "batch); zero-shot/--coop-prompt ViT paths")
    p.add_argument("--calibration-images", default=None,
                   help="image file or directory: representative batch "
                        "for static w8a8 activation scales "
                        "(ops/quant.attach_act_scales); requires "
                        "--quantize w8a8")
    p.add_argument("--act-scales", default=None,
                   help="npz of previously captured activation stats "
                        "(ops/quant.save_act_stats): attach static "
                        "w8a8 scales WITHOUT calibration images on "
                        "this host; requires --quantize w8a8")
    p.add_argument("--save-act-scales", default=None,
                   help="after calibrating with --calibration-images, "
                        "persist the captured stats to this npz for "
                        "later --act-scales use")
    p.add_argument("--topk", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the towers and kernels run (default: "
                        "cuda; there is no fallback to the CPU)")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides KEY VALUE ... (trainer builds)")
    return p


def _classnames(args) -> list:
    if args.classnames_file:
        with open(args.classnames_file) as f:
            return [ln.strip() for ln in f if ln.strip()]
    if args.classnames:
        return list(args.classnames)
    raise SystemExit("--classnames or --classnames-file is required")


def _image_paths(spec: str) -> list:
    import os
    if osp.isdir(spec):
        out = [osp.join(spec, n) for n in sorted(os.listdir(spec))
               if n.lower().endswith(IMG_EXTS)]
        if not out:
            raise SystemExit(f"no images under {spec}")
        return out
    if not osp.exists(spec):
        raise SystemExit(f"no such file: {spec}")
    return [spec]


def _host_transform(args, resolution: int):
    """Eval-geometry transform matching the checkpoint's training run:
    ``--config-file`` (+opts) supplies the INPUT tree verbatim; without
    one, shorter-side BICUBIC + center crop — the geometry of every
    shipped trainer yaml and of the reference CLIP eval pipeline
    (``clip/clip.py:74-81``), not the bare Dassl bilinear default."""
    from .config import get_cfg_default
    from .data.transforms import build_transform

    cfg = get_cfg_default()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
        if args.opts:
            cfg.merge_from_list(list(args.opts))
    else:
        cfg.INPUT.INTERPOLATION = "bicubic"
    # the model resolution is authoritative (predict() validates it)
    cfg.INPUT.SIZE = (resolution, resolution)
    return build_transform(cfg, is_train=False)


def _load_images(paths, resolution: int, on_device: bool,
                 args) -> np.ndarray:
    """uint8 [N, H, W, 3]: eval geometry host-side, or raw pixels for
    device-side geometry (all sources must share one size then)."""
    from PIL import Image

    if not on_device:
        tf = _host_transform(args, resolution)
        return np.stack([tf(Image.open(p)) for p in paths])
    arrs = [np.asarray(Image.open(p).convert("RGB"), np.uint8)
            for p in paths]
    if len({a.shape for a in arrs}) != 1:
        raise SystemExit(
            "--preprocess-on-device needs uniform source sizes "
            "(one compiled geometry); resize host-side or drop the flag")
    return np.stack(arrs)


def _mesh_shape(spec: str) -> tuple:
    return tuple(int(x) for x in spec.split(","))


def build_predictor(args, classnames):
    from .serving import Predictor, TrainerPredictor

    conf = (np.load(args.class_confidence)
            if args.class_confidence else None)

    if args.checkpoint_dir and not args.coop_prompt:
        if args.temperature is not None:
            # silently serving untempered probabilities would be the
            # exact miscalibration this CLI exists to prevent
            raise SystemExit(
                "--temperature does not apply to trainer checkpoints; "
                "express a fitted temperature as a TempScaling "
                "checkpoint (it serves dataset-free)")
        if args.preprocess_on_device:
            raise SystemExit(
                "--preprocess-on-device covers the zero-shot/"
                "--coop-prompt paths only (serving.Predictor); trainer "
                "checkpoints need host-side geometry at the model "
                "resolution")
        if args.quantize or args.calibration_images or args.act_scales \
                or args.save_act_scales:
            # trainers run the parity-exact eval path; quantization is
            # a Predictor-side serving transform (ops/quant.py)
            raise SystemExit(
                "--quantize/--calibration-images/--act-scales/"
                "--save-act-scales cover the zero-shot/--coop-prompt "
                "paths only (serving.Predictor)")
        opts = list(args.opts or [])
        if args.mesh:
            # the trainer builds its own mesh from TPU.MESH_SHAPE
            opts += ["TPU.MESH_SHAPE", repr(_mesh_shape(args.mesh))]
        return TrainerPredictor.from_checkpoint(
            args.checkpoint_dir, classnames, trainer_name=args.trainer,
            backbone=args.backbone, config_file=args.config_file,
            opts=opts or None, epoch=args.epoch,
            class_confidence=conf, batch_size=args.batch_size,
            device=args.device)
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh
        mesh = make_mesh(_mesh_shape(args.mesh))
    kwargs = dict(precision=args.precision, batch_size=args.batch_size,
                  class_confidence=conf, temperature=args.temperature,
                  mesh=mesh, preprocess_on_device=args.preprocess_on_device,
                  quantize=args.quantize, device=args.device)
    if args.calibration_images:
        if args.quantize != "w8a8":
            raise SystemExit("--calibration-images requires "
                             "--quantize w8a8 (static activation "
                             "scales, ops/quant.py)")
        from .models.clip import PRESETS
        res = PRESETS[args.backbone].image_resolution
        kwargs["calibration_images"] = _load_images(
            _image_paths(args.calibration_images), res, False, args)
    if args.act_scales:
        if args.quantize != "w8a8":
            raise SystemExit("--act-scales requires --quantize w8a8 "
                             "(static activation scales, ops/quant.py)")
        kwargs["act_scales"] = args.act_scales
    if args.save_act_scales and not args.calibration_images:
        raise SystemExit("--save-act-scales persists stats captured by "
                         "--calibration-images (nothing to save "
                         "without them)")
    if args.checkpoint_dir:
        pred = Predictor.from_prompt_checkpoint(
            args.backbone, classnames, args.checkpoint_dir,
            epoch=args.epoch, **kwargs)
    else:
        pred = Predictor(args.backbone, classnames,
                         template=args.template, **kwargs)
    if args.save_act_scales:
        from .ops.quant import save_act_stats
        save_act_stats(args.save_act_scales, pred.act_stats)
        print(f"activation scales saved: {args.save_act_scales}")
    return pred


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def _serve_http(args, pred, classnames, resolution: int, device) -> int:
    """The resident server on rank 0 (on a mesh its predictor behind
    ``MeshPredictor``); every other rank follows it. Ends on Ctrl-C or
    SIGTERM; the followers get the stop code before the server closes."""
    import signal

    from .http_server import serve_http
    from .parallel.http_mesh import MeshPredictor, follow
    from .parallel.mesh import world

    rank, n = world()
    if rank != 0:
        follow(pred, device)
        return 0
    front = MeshPredictor(pred, device) if n > 1 else pred
    old = signal.signal(signal.SIGTERM, _interrupt)
    server = None
    try:
        # pre-warm before accepting traffic, not on the first clients'
        # requests (kernel builds, allocator growth): the lone-request
        # bucket and the full coalesced batch, the JAX package's two
        front.predict(np.zeros((1, resolution, resolution, 3), np.uint8))
        front.predict(np.zeros((args.batch_size, resolution, resolution,
                                3), np.uint8))
        server = serve_http(
            args.http, front, classnames,
            _host_transform(args, resolution), topk=args.topk,
            max_wait_ms=args.max_wait_ms, backbone=args.backbone)
        host, port = server.server_address[:2]
        print(f"serving on http://{host}:{port}  "
              f"(POST /predict, GET /healthz /classes /stats)",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        if front is not pred:
            front.stop()
        if server is not None:
            server.server_close()
        signal.signal(signal.SIGTERM, old)
    return 0


def main(argv=None) -> int:
    import torch

    from .tools.device import resolve_device

    args = build_parser().parse_args(argv)
    rank = 0
    if args.mesh and os.environ.get("CC_COORD_ADDR"):
        # one process per device: join the cluster before any device
        # query (each rank takes cuda:{rank % device count})
        from .parallel.mesh import initialize_distributed
        initialize_distributed(device=args.device)
        rank = torch.distributed.get_rank()
    device = resolve_device(args.device)  # raises without a card
    # fp32 serving stays full fp32 on the card (no TF32 matmuls or convs)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.http is None and args.images is None:
        raise SystemExit("--images (batch mode) or --http (server "
                         "mode) is required")
    classnames = _classnames(args)
    paths = _image_paths(args.images) if args.images else []

    pred = build_predictor(args, classnames)
    res = getattr(pred, "cfg", None)
    if res is None:
        # every trainer exposes clip_cfg — scaling trainers
        # (TempScaling/PTS) by delegation to their wrapped base learner
        res = pred.trainer.clip_cfg
    resolution = res.image_resolution

    if args.http is not None:
        if args.preprocess_on_device:
            raise SystemExit("--preprocess-on-device is a batch-mode "
                             "knob; HTTP mode decodes per request "
                             "host-side")
        return _serve_http(args, pred, classnames, resolution, device)

    images = _load_images(paths, resolution, args.preprocess_on_device,
                          args)
    out = pred.predict(images)

    if rank != 0:  # every rank holds the result; rank 0 writes it
        return 0
    k = max(1, min(args.topk, len(classnames)))
    order = np.argsort(-out["probs"], axis=1)[:, :k]
    sink = sys.stdout if args.out == "-" else open(args.out, "w")
    try:
        for i, path in enumerate(paths):
            row = {
                "image": path,
                "pred": classnames[int(out["preds"][i])],
                "confidence": round(float(out["confidences"][i]), 6),
            }
            if k > 1:
                row["topk"] = [
                    {"class": classnames[int(j)],
                     "prob": round(float(out["probs"][i, j]), 6)}
                    for j in order[i]]
            sink.write(json.dumps(row) + "\n")
    finally:
        if sink is not sys.stdout:
            sink.close()
            print(f"wrote {len(paths)} predictions to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Interpret learned prompt vectors as nearest vocabulary words.

    python -m clip_calibration_tpu_torch.interpret_prompt <ckpt> <topk> \
        [--backbone ViT-B/16] [--device cuda|cpu]

Counterpart of ``interpret_prompts/interpret_prompt.py``, with the port's
``load_checkpoint``, ``load_clip_backbone`` and ``CLIPTokenizer``: loads a
prompt checkpoint (native npz or reference torch), computes the Euclidean
distance from each learned context vector (the shallow ``ctx`` and the
per-layer compound/deep text prompts) to every token embedding of the CLIP
vocabulary, and prints the top-k nearest words, line for line as the JAX
script does. The distances are numpy on the host; ``--device`` is where
the backbone is built (default ``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from clip_calibration_tpu_torch.engine.checkpoint import load_checkpoint
from clip_calibration_tpu_torch.models.backbone import load_clip_backbone
from clip_calibration_tpu_torch.models.tokenizer import CLIPTokenizer


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def nearest_words(ctx: np.ndarray, token_embedding: np.ndarray,
                  tokenizer: CLIPTokenizer, topk: int):
    """ctx: [n_ctx, D] or [n_cls, n_ctx, D]."""
    if ctx.ndim == 2:
        ctx = ctx[None]
    for row in range(ctx.shape[0]):
        if ctx.shape[0] > 1:
            print(f"--- class/prompt {row}")
        for m, vec in enumerate(ctx[row]):
            dists = np.linalg.norm(token_embedding - vec[None], axis=1)
            idxs = np.argsort(dists)[:topk]
            words = [tokenizer.decoder[int(i)] for i in idxs]
            dist_str = [f"{dists[i]:.4f}" for i in idxs]
            print(f"{m + 1}: {words} {dist_str}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("fpath", type=str,
                        help="path to the learned prompt checkpoint")
    parser.add_argument("topk", type=int,
                        help="select top-k similar words")
    parser.add_argument("--backbone", type=str, default="ViT-B/16")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    assert os.path.exists(args.fpath)
    print(f"Return the top-{args.topk} matched words")

    tokenizer = CLIPTokenizer()
    model, _ = load_clip_backbone(args.backbone, device=args.device)
    token_embedding = _np(model.text.token_embedding)
    print(f"Size of token embedding: {token_embedding.shape}")

    state = load_checkpoint(args.fpath)["state_dict"]

    # shallow context (all prompt trainers name it "ctx"; reference torch
    # checkpoints prefix with "prompt_learner.")
    layers = []
    ctx = state.get("ctx")
    if ctx is None:
        ctx = state.get("prompt_learner", {}).get("ctx") \
            if isinstance(state.get("prompt_learner"), dict) else None
    if ctx is not None:
        layers.append(("shallow ctx", _np(ctx)))

    # per-layer compound/deep text prompts (MaPLe / PromptSRC); the
    # reference's torch MaPLe checkpoints store them as
    # compound_prompts_text.<i> (unflattened to a nested dict here)
    for key in ("compound_text", "deep_text"):
        if key in state:
            stack = _np(state[key])
            for i in range(stack.shape[0]):
                layers.append((f"layer {i + 1} ({key})", stack[i]))
    ref = state.get("compound_prompts_text")
    if isinstance(ref, dict):
        for i in sorted(ref, key=int):
            layers.append((f"layer {int(i) + 1} (compound_prompts_text)",
                           _np(ref[i])))

    if not layers:
        print("No prompt vectors found in checkpoint; keys:",
              sorted(state))
        return

    for name, ctx in layers:
        print(f"SHOWING RESULTS FOR: {name}  shape={ctx.shape}")
        nearest_words(ctx, token_embedding, tokenizer, args.topk)


if __name__ == "__main__":
    main()

"""Parameterized temperature scaling (PTS).

Counterpart of
``clip_calibration_tpu/trainers/calibration/parameterized_tempscaling.py``.
The reference defines the config tree (``train.py:243-247``:
``CALIBRATION.P_TS.{N_LAYERS, N_NODES, TOP_K_LOGITS}``) and a script
branch (``run/calibration/fewshot_scaling.sh:68-70``) but registers no
implementation; the JAX package's: a per-sample log-temperature predicted
by a small MLP over the sorted top-k logits (PTS, Tomani et al., ECCV
2022), on TempScaling's base-learner wrapping, data routing and
checkpoint naming.

    logits_calibrated = cos_logits * exp(s0 + MLP(topk(cos_logits)))

with s0 initialized to INIT_TEMP (ln 100), so it starts at TempScaling's
init.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...engine.registry import TRAINER_REGISTRY
from .tempscaling import TempScaling


def pts_log_scale(params, cos_logits: torch.Tensor) -> torch.Tensor:
    """[N, C] unit logits -> [N] per-sample log temperature scale.

    The MLP's input width is TOP_K_LOGITS whatever the class count, so a
    base-split checkpoint loads into a new-split eval; with fewer classes
    than k the sorted logits are padded with the row minimum."""
    k = params["w_in"].shape[0]
    n_cls = cos_logits.shape[-1]
    if n_cls >= k:
        top = torch.topk(cos_logits, k, dim=-1).values  # descending
    else:
        top = torch.sort(cos_logits, dim=-1, descending=True).values
        top = torch.cat([top, top[..., -1:].expand(
            *top.shape[:-1], k - n_cls)], dim=-1)
    h = torch.relu(top @ params["w_in"] + params["b_in"])
    # stacked [n_mid, nodes, nodes] hidden layers (possibly none)
    for i in range(params["ws"].shape[0]):
        h = torch.relu(h @ params["ws"][i] + params["bs"][i])
    out = h @ params["w_out"] + params["b_out"]  # [N, 1]
    return params["s0"] + out[:, 0]


def init_pts_params(k: int, nodes: int, n_layers: int, init_temp: float,
                    seed: int = 0, device="cpu") -> dict:
    """PTS tensors: N_LAYERS hidden layers of N_NODES, ``w_in`` the
    first, the stacked mid layers the rest; the output layer starts near
    zero, so the scale starts near ``init_temp``. Drawn from a generator
    seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(max(seed, 0))

    def lin(fan_in, fan_out):
        lim = (1.0 / fan_in) ** 0.5
        return (torch.rand((fan_in, fan_out), generator=gen,
                           device=device) * 2 - 1) * lim

    n_mid = max(n_layers - 1, 0)
    zeros = torch.zeros
    return {
        "s0": torch.tensor(init_temp, dtype=torch.float32, device=device),
        "w_in": lin(k, nodes),
        "b_in": zeros((nodes,), device=device),
        "ws": (torch.stack([lin(nodes, nodes) for _ in range(n_mid)])
               if n_mid else zeros((0, nodes, nodes), device=device)),
        "bs": zeros((n_mid, nodes), device=device),
        "w_out": lin(nodes, 1) * 0.01,
        "b_out": zeros((1,), device=device),
    }


@TRAINER_REGISTRY.register()
class ParameterizedTempScaling(TempScaling):

    def init_scale_params(self) -> dict:
        # in place of TempScaling's one scale; the width is fixed (see
        # pts_log_scale) so checkpoints load across base/new splits
        p = self.cfg.CALIBRATION.P_TS
        return init_pts_params(p.TOP_K_LOGITS, p.N_NODES, p.N_LAYERS,
                               self.cfg.CALIBRATION.SCALING.INIT_TEMP,
                               seed=self.cfg.SEED, device=self.device)

    def forward_backward(self, batch):
        cos, labels = self._cached_cos(batch)
        params = self.model_params("scale_learner")
        self.optimizer("scale_learner").zero_grad(set_to_none=True)
        logits = torch.exp(pts_log_scale(params, cos))[:, None] * cos
        loss = F.cross_entropy(logits, self.put_batch(labels).long())
        loss.backward()
        self.optimizer_step("scale_learner")
        return {"loss": loss.detach()}

    def model_inference(self, images):
        cos, img_f, txt_f = self._unit_logits(images)
        with torch.no_grad():
            s = pts_log_scale(self.model_params("scale_learner"), cos)
        return cos * torch.exp(s)[:, None], img_f, txt_f

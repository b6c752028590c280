"""LayerNorm kernel launches per untraced CoOp step, forward and backward: the program's ln.calls count (ops/layer_norm.py, one per launch of either kernel) over its train.step count, both written only with no profiler running, so over the same steps (set-up's checked steps and the window's untraced ones). A step runs every vision LayerNorm forward (2 a layer, ln_pre, ln_post) and every text LayerNorm forward and backward (2 a layer, ln_final): 76 at B/16, 100 at L/14, 228 at bigG; fewer says a LayerNorm left the kernels. A program without the counter reads None."""


def read(reading):
    try:
        from clip_calibration_tpu_torch.tools.profiling import snapshot
    except ImportError:
        return None
    snap = snapshot()
    calls, steps = snap.get("ln.calls"), snap.get("train.step")
    if calls is None or steps is None or steps["count"] == 0:
        return None
    return calls["total"] / steps["count"]

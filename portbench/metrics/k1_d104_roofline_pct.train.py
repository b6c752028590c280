"""K1 at head dim 104 (OpenCLIP ViT-bigG/14's vision attention): the sum of flops.k1's bounds over the traced slice's K1 calls whose head dim is 104, over the device time of the kernels whose trace name holds that instance (mha_qkv_fwd_bf16<104, ...>). A call counts the data's tokens and its 104 columns, never a pad's."""

from portbench import readers

#: the trace name's part that only the head-dim-104 instance has
KERNEL = "mha_qkv_fwd_bf16<104"


def read(reading):
    calls = [c for c in reading.calls.get("k1", [])
             if c[2] // 3 // c[3] == 104]
    t = reading.summary.kernel_seconds(KERNEL)
    if not calls or t <= 0:
        return None
    return 100.0 * sum(readers._launch_bound("k1", c) for c in calls) / t

"""The coordinate-wise sorted reduction (``csrc/sorted_reduce.cu``): the
trimmed mean or median of each column of ``U`` ``[C, D]`` f32.

One call reads ``U`` once and writes ``[D]`` f32 once. Its work is
comparisons, not multiply-adds, so the bytes bound it: at [100, 421,642]
0.051 ms.
"""

KERNELS = ("sorted_reduce_kernel",)


def cost(call, d):
    c = int(call["rows"])
    return 4 * (c * d + d), 0.0, "float32"


def logical_flops(call, d):
    return 0

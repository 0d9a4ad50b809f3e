"""The centered Gram matrix (``csrc/gram.cu``): ``G = (U - mu)(U - mu)^T``.

One call reads ``U`` ``[C, D]`` f32 and the column mean ``mu`` ``[D]`` once
and writes ``G`` ``[C, C]`` f32 once. Its products are the ``C (C + 1) / 2``
dot products of one triangle and the diagonal, ``C (C + 1) D`` operations,
at the f32-accurate 3xTF32 rate. At [100, 421,642] the bound is 0.050 ms,
set by the bytes.
"""

KERNELS = ("gram_tc_kernel", "gram_reduce_kernel")


def cost(call, d):
    c = int(call["rows"])
    return 4 * (c * d + d + c * c), c * (c + 1) * d, "float32"


def logical_flops(call, d):
    """``2 C^2 D``: the full product, as the round's FLOP count takes it."""
    c = int(call["rows"])
    return 2 * c * c * d

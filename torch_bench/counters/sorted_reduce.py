"""Launches of the sorted-reduce kernel
(``ops/sorted_reduce.py::sorted_reduce.launches``)."""


def read() -> int:
    from multimodal_fl_security_tpu_torch.ops.sorted_reduce import (
        sorted_reduce,
    )
    return int(sorted_reduce.launches)

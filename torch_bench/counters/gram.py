"""Launches of the Gram kernel (``ops/gram.py::gram.launches``)."""


def read() -> int:
    from multimodal_fl_security_tpu_torch.ops.gram import gram
    return int(gram.launches)

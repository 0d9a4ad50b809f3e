"""Each kernel's bytes and operations at a call's shape, one file a kernel.

A module ``<kernel>.py`` defines ``KERNELS`` (the device kernels of one
call, by the name the profiler gives them), ``cost(call, d) -> (bytes,
flops, kind)`` for the call's shape in the traffic mix (``call`` is the
mix's ``kernels[<kernel>]`` entry, ``d`` the model's parameter count) and
``logical_flops(call, d)``, the call's useful operations for ``mfu``.
Each input byte is counted once and each output byte once.
"""

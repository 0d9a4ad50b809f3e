"""PyTorch / CUDA port of ``multimodal_fl_security_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
the name and path of its counterpart there, and the tests under
``tests/test_torch_port_*.py`` hold each one to it on identical inputs.

This package imports ``torch`` and numpy only, never JAX. Clients are a
batch dimension written out: the client-stacked parameters live in one flat
``[C, D]`` f32 buffer with per-layer views (``core/pytrees.py``), local
training runs grouped convolutions and batched GEMMs over that buffer, and
Krum's centered Gram matrix runs as a CUDA kernel written for ``sm_90a``
(``csrc/gram.cu``).

Typical use::

    from multimodal_fl_security_tpu_torch.bench import build_engine
    engine, params, test = build_engine(device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, metrics = engine.run_round(params, gen)
"""

__version__ = "0.1.0"

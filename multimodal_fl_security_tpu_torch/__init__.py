"""PyTorch / CUDA port of ``multimodal_fl_security_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: every module here keeps
the name and path of its counterpart there, and the tests under
``tests/test_torch_port_*.py`` hold each one to it on identical inputs.

This package imports ``torch`` and numpy only, never JAX. Clients are a
batch dimension written out: the client-stacked parameters live in one flat
``[C, D]`` f32 buffer with per-layer views (``core/pytrees.py``), local
training runs grouped convolutions and batched GEMMs over that buffer, and
the robust aggregators run on two CUDA kernels written for ``sm_90a``: the
centered Gram matrix behind Krum's and Bulyan's distances
(``csrc/gram.cu``) and the column-wise sorted reduction behind the
coordinate median, the trimmed mean, the geometric median's start and
Bulyan's aggregate (``csrc/sorted_reduce.cu``).

Typical use::

    from multimodal_fl_security_tpu_torch.bench import build_engine
    engine, params, test = build_engine(device="cuda")  # Krum, no attack
    # or, e.g., build_engine("cuda", defense="trimmed_mean", attack="alie",
    #                        attack_config={"num_malicious": 20},
    #                        num_malicious_clients=20)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, metrics = engine.run_round(params, gen)
"""

__version__ = "0.1.0"

"""The benchmark of the PyTorch / CUDA port (``multimodal_fl_security_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m torch_bench.run --workload trimmed_alie_c100_f32 --seed 7 \
        --seconds 10 --trace 0

Everything a cell is made of is found by name: its model configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
the limits of its correctness check in ``limits/<workload>.json``, each
end-to-end metric's reader in ``end_to_end/<name>.py``, each per-layer
metric's reader in ``metrics/<name>.py``, each kernel's bytes and operations
in ``rooflines/<kernel>.py``, each program counter in ``counters/<name>.py``
and the plain reference of each model, attack and defense in
``reference/{models,attacks,defenses}/<name>.py``. A new cell, metric or
defense is new files and entries; no file here needs an edit for it.

The program is driven only through its public constructors (``models``,
``attacks``, ``defenses``, ``rounds.engine``, ``data.stacking``); nothing
here imports JAX or the JAX package.
"""

"""The benchmark of ``cloudsc2jax_torch`` on NVIDIA cards: cells of a
configuration and a traffic mix, run one at a time by ``python3 -m
benchmark.run`` (see ``benchmark/run.py``)."""

"""PyTorch port of the CE-FedAvg system (``repro``), for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

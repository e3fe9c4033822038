"""Data parallelism, one process per card, and key sharding over a
(data, seq) grid of ranks (torch counterpart of `vdetr_tpu/parallel/`)."""

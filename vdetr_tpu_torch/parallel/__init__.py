"""Data parallelism: one process per card (torch counterpart of
`vdetr_tpu/parallel/`)."""

"""Model builders (``bigdl_tpu/models`` counterparts)."""

"""Serving path: fused encode+scan and the search microbatcher
(port of memex_tpu/serve)."""

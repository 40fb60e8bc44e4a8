"""Device-side models (port of memex_tpu/models): the MiniLM encoder."""

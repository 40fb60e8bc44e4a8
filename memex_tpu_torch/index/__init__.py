"""Device-resident vector indexes (port of memex_tpu/index): the flat tier."""

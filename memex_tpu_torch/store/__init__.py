"""Vector stores behind the URI schemes (port of memex_tpu/store)."""

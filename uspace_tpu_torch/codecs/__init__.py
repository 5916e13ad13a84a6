"""Weight converters (counterpart of uspace_tpu/codecs)."""

"""Serving: the port's backend for whisperlive_tpu.serving.server."""

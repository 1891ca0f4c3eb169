"""Serving: the port's server, session, and TorchBackend."""

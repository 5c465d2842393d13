"""The port's rank worker (``repro.substrate`` is the reference); the
controller-side substrates wait for a later slice."""

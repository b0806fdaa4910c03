"""The port's launch backends for the reference control plane: the
operator, the experiment loop and Scoring drive port processes through
``backends.LocalProcessBackend`` (training) and
``serving/local_backend.LocalServingBackend`` (serving)."""

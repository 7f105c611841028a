"""Training core of the port: initializers, losses, metrics,
optimizers and the single-device executor."""

"""Training: the step builder, optimizers and the thinned gradient sync."""

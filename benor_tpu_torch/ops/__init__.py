"""Device operations of the port: stream math, gate predicates, round kernels."""

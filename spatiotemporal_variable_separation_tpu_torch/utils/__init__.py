"""Weight transfer from the JAX package's variables, profiling, config I/O
helpers and filmstrip rendering."""

"""The options the solve reads (the port keeps only these)."""

# Batches below this many pods route to the exact host loop. This is the
# reference's value; it has not been measured for this port. A deployment
# measures its own with solver/dense.py:measure_dense_crossover and passes
# it to DenseSolver as min_batch.
DENSE_MIN_BATCH_DEFAULT = 320

"""Graph generators, one module each, found by a configuration's
`graph.generator` name (see `gqe_bench/data.py`)."""

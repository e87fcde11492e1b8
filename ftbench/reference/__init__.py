"""Plain float32 PyTorch references of the configurations the benchmark
serves, one module a model family (named by a configuration file's
"reference" key). Each module defines

- `make_weights(sizes, seed, device)`: the seeded weights, drawn on
  `device` in a few large calls, in the parameter layout the port's
  `Model` takes; the benchmark hands the same tensors to the program and
  to the reference;
- `logits_at(params, sizes, requests, *, lanes, quant=None)`: for each
  request (prompt, served tokens), the float32 logits at the positions
  that produced its served tokens, computed in blocks; `quant="fp8"`
  computes every matmul on operands rounded to float8 e4m3 (the control).

Nothing here imports the program, the JAX package or JAX.
"""

"""Thread budget of the port's CPU tests (``tests/test_torch_*.py``).

Each of them imports this module in place of a count of its own.  Every
pytest-xdist worker imports every test module while it collects, so a
count set at import holds in all workers, whichever module sets it last;
here it is set once: one torch intra-op thread per worker, so a port
test takes one core beside the JAX package's files on the six workers
that share the machine's cores.  The JAX package's thread pools are not
changed.
"""

import torch

torch.set_num_threads(1)

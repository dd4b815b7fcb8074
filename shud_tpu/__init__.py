"""shud_tpu — a JAX watershed hydrology framework.

A from-scratch JAX/XLA reimplementation of the capabilities of the SHUD-up
reference model (physically-based, fully-coupled, distributed watershed
hydrology on an unstructured triangular mesh), redesigned for
accelerators:

* the semi-discrete FVM right-hand side is a single pure, jittable function
  built from gathers over static neighbor index arrays and ``segment_sum``
  reductions (reference: serial loops in ``src/ModelData/MD_f.cpp``);
* CVODE's adaptive BDF (reference: ``src/Equations/cvode_config.cpp``) is
  replaced by a jittable adaptive implicit multistep solver with
  Newton–Krylov inner iterations driven by exact JVPs;
* multi-device scaling uses ``jax.sharding``/``shard_map`` domain decomposition
  of the cell axis with ghost-ring halo exchange (the reference's only
  parallelism is OpenMP threads, ``src/ModelData/MD_f_omp.cpp``).

Units convention (identical to the reference): length = m, time = minutes
internally.  All inputs are converted at read time.
"""

from shud_tpu import config as config
from shud_tpu.config import enable_x64

enable_x64()

__version__ = "0.1.0"

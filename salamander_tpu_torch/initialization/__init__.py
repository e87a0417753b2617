"""Model-parameter initialization (layer L1).

Host-side numpy methods copied from the JAX package reproduce the
reference's exact random draws (global np.random seeding); a
torch.Generator-based batch initializer serves the multi-start fit.
"""

from .initialize import (  # noqa: F401
    EPSILON,
    GIVEN_PARAMETERS_STANDARD_NMF,
    initialize_mat,
    initialize_standard_nmf,
)
from .methods import INIT_METHODS, random_init_batch  # noqa: F401

"""Host-side data pipeline (port of the JAX package's ``data``: numpy, so
the arrays are identical)."""
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import (client_weights, dirichlet_partition,
                                        iid_partition)
from repro_torch.data.synthetic import (SyntheticImages, SyntheticTokens,
                                        round_batches)

__all__ = [
    "FederatedLoader", "client_weights", "dirichlet_partition",
    "iid_partition", "SyntheticImages", "SyntheticTokens", "round_batches",
]

"""Counter-keyed workload generators (the port of ``repro.core.scenarios``):
``base`` for the contract and the PRNG plumbing, ``streams`` for the
generator families, ``combinators`` for ``combine`` and the seed axis."""
from repro_torch.core.scenarios.base import (ObsSlab, Scenario, Stream,
                                             as_keys, bcast, chunk_geometry,
                                             fold_in, materialize,
                                             materialize_stream,
                                             prng_key, shared_keys,
                                             slot_uniform, split_keys)
from repro_torch.core.scenarios.combinators import (combine,
                                                    replicate_seeds,
                                                    with_seed)
from repro_torch.core.scenarios.streams import (BURSTY_EXIT_P, arma_rents,
                                                bernoulli_arrivals,
                                                bursty_arrivals,
                                                constant_rents, ge_arrivals,
                                                model2_service, na_rents,
                                                poisson_arrivals,
                                                spot_bounds, spot_rents,
                                                trace_arrivals, trace_rents,
                                                uniform_rents)

__all__ = [
    "ObsSlab", "Scenario", "Stream", "as_keys", "bcast", "chunk_geometry",
    "fold_in", "materialize", "materialize_stream", "prng_key", "shared_keys",
    "slot_uniform", "split_keys",
    "combine", "replicate_seeds", "with_seed",
    "BURSTY_EXIT_P", "arma_rents", "bernoulli_arrivals", "bursty_arrivals",
    "constant_rents", "ge_arrivals", "model2_service", "na_rents",
    "poisson_arrivals", "spot_bounds", "spot_rents", "trace_arrivals",
    "trace_rents", "uniform_rents",
]

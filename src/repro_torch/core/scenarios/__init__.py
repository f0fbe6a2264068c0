"""Counter-keyed workload generators (the port of ``repro.core.scenarios``):
``base`` for the contract, the PRNG plumbing and the PRNG backend switch,
``streams`` for the generator families, ``combinators`` for ``combine``,
mixtures, regime switching, antithetic pairing, trace playback, the seed
axis and the service axis."""
from repro_torch.core.scenarios.base import (PRNG_BACKENDS, ObsSlab, Scenario,
                                             Stream, as_keys, bcast,
                                             chunk_geometry, fold_in,
                                             materialize, materialize_stream,
                                             prng_key, shared_keys,
                                             slot_keys, slot_uniform,
                                             split_keys)
from repro_torch.core.scenarios.combinators import (antithetic_pairing,
                                                    combine, mixture,
                                                    mixture_from_weights,
                                                    regime_switch,
                                                    replicate_seeds,
                                                    tile_services,
                                                    trace_scenario,
                                                    with_prng_backend,
                                                    with_seed)
from repro_torch.core.scenarios.streams import (BURSTY_EXIT_P,
                                                adversarial_evict_bait,
                                                adversarial_fetch_bait,
                                                arma_rents,
                                                bernoulli_arrivals,
                                                bursty_arrivals,
                                                constant_rents, ge_arrivals,
                                                model2_service, na_rents,
                                                poisson_arrivals,
                                                spot_bounds, spot_rents,
                                                trace_arrivals, trace_rents,
                                                uniform_rents)

__all__ = [
    "ObsSlab", "PRNG_BACKENDS", "Scenario", "Stream", "as_keys", "bcast",
    "chunk_geometry", "fold_in", "materialize", "materialize_stream",
    "prng_key", "shared_keys", "slot_keys", "slot_uniform", "split_keys",
    "antithetic_pairing", "combine", "mixture", "mixture_from_weights",
    "regime_switch", "replicate_seeds", "tile_services", "trace_scenario",
    "with_prng_backend", "with_seed",
    "BURSTY_EXIT_P", "adversarial_evict_bait", "adversarial_fetch_bait",
    "arma_rents", "bernoulli_arrivals", "bursty_arrivals", "constant_rents",
    "ge_arrivals", "model2_service", "na_rents", "poisson_arrivals",
    "spot_bounds", "spot_rents", "trace_arrivals", "trace_rents",
    "uniform_rents",
]

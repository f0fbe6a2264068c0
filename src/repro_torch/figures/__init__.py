"""The paper's figure benchmarks on the port (the counterparts of
``benchmarks/fig*.py``): each module's ``run(T, seed, n_seeds, device)``
builds the reference's grids and keys and returns the same rows, bitwise
on the CPU; ``check(rows)`` is a copy of the reference module's check.

* ``fig01_02_alpha_sweep`` -- cost and hosting histogram vs alpha + g.
* ``fig03_06_m_p_sweeps`` -- cost vs fetch cost M and arrival rate p.
* ``fig07_08_multiple_rr`` -- multiple-RR vs alpha-RR vs RR under GE
  arrivals.
* ``fig10_11_trace`` -- cost vs M under bursty (GE-Poisson) arrivals and
  spot rents.
* ``fig12_15_poisson_model2`` -- Model-2 service under Poisson arrivals:
  histograms and cost vs M and vs the rent.
* ``fig17_22_markov_mdp`` -- Model-2 service under GE-Poisson arrivals:
  alpha-RR and RR against the MDP and ABC baselines in three regimes.
* ``fig23_25_geolife`` -- the measured g-curve of the shortest-path
  service, cost vs cache fraction and vs M at the best alpha.
* ``beyond_knapsack_levels`` -- multi-level grids picked from that curve
  (26 lanes of 2 to 8 levels on one 31-level Model-2 slab).
* ``theorems`` -- the theorem checks: Thm 2's worst ratio over 120 random
  instances of mixed horizons (one obs-backed fleet; ``run(seed,
  device)``), and the bounds of Thms 4-5 and Corollary 3.
"""

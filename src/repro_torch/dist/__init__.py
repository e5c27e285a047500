"""The fleet's client axis across ranks: `sharding` (the mesh, each rank's
slab, the process group over the data axes, gathers) and `collectives`
(valid-weighted reductions and the all-reduce of a round's row of
sums)."""

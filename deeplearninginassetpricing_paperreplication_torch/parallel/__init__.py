"""Member-stacked ensembles, the partition layer (``partition``, ``mesh``)
and the collectives of stock-sharded training (``collectives``)."""

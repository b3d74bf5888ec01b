"""Member-stacked ensembles."""

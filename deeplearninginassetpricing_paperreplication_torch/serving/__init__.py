"""Serving: the inference engine and its HTTP front end."""

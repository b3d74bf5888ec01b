"""Model-health observability, copied from the JAX package's
``observability/`` (no side effects on import; nothing here imports torch
at module level):

  * :mod:`.drift`       — reference profiles of a panel and PSI/KS drift
    scores against them (numpy only);
  * :mod:`.modelhealth` — ``health.json``, the gate's health thresholds and
    the candidate diagnostics (torch loaded lazily).
"""

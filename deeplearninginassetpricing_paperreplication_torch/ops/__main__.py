"""``python -m ….ops`` — the cross-plane ops console entry point (the
port's copy of the JAX package's ``ops/__main__.py``).

The console itself lives in :mod:`..observability.statusboard` (stdlib
file reading; byte-deterministic ``status`` / ``timeline``); this shim
only gives it the ``ops`` command name.
"""

import sys

from ..observability.statusboard import main

if __name__ == "__main__":
    sys.exit(main())

"""`python -m fluidsimulation` launches the demo CLI (app/demo.py)."""

import sys

from fluidsimulation.app.demo import main

if __name__ == "__main__":
    sys.exit(main())

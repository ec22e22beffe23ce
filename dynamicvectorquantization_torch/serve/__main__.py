"""`python -m dynamicvectorquantization_torch.serve`: see `serve/http.py`."""
import sys

from .http import main

if __name__ == "__main__":
    sys.exit(main())

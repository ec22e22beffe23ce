"""`python -m dynamicvectorquantization_torch.train`: see `train/cli.py`."""
from .cli import main

if __name__ == "__main__":
    main()

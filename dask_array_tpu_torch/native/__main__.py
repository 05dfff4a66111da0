"""CLI: python -m dask_array_tpu_torch.native [--force] builds libplankit."""

import sys

from dask_array_tpu_torch.native import PLANKIT_GENERATION, available, build

if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(f"plankit generation {PLANKIT_GENERATION}: {'OK ' + str(path) if path else 'build FAILED'}")
    print("available:", available())

"""``python3 -m digiham_tpu_torch.bench``: the headline (see
:mod:`.headline`)."""
import sys

from .headline import main

if __name__ == "__main__":
    sys.exit(main())

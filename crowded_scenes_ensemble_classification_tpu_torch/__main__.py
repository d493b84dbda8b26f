import sys

from .cli.main import main

if __name__ == "__main__":  # `python -m`; importing the module runs nothing
    sys.exit(main())

import sys

from .runner import main

if __name__ == "__main__":    # importing every module must not run a scan
    sys.exit(main())

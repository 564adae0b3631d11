import sys

from gar_bench.run import main

sys.exit(main())

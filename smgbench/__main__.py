import sys

from smgbench.run import main

sys.exit(main())

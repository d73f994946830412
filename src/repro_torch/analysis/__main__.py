import os
import sys

from .cli import main

try:
    rc = main()
except BrokenPipeError:
    # downstream pager/head closed the pipe; point stdout at devnull so
    # interpreter shutdown doesn't print a second traceback
    os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    rc = 0
raise SystemExit(rc)

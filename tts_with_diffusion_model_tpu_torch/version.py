"""Version stamp.  ``setup.py`` regenerates this from git at build time
(the reference's git-commit-time version scheme)."""

__version__ = "0.1.0"
__commit__ = ""

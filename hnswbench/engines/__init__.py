"""The systems under test, one file each (see ``block.py``)."""

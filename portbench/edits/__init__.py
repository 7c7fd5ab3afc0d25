"""Edit kinds: what a traffic mix changes in the scene between steps, one
module a kind (``edits/<kind>.py``), named by a mix's ``edits.kind`` key.
See ``drive.py``."""

"""Call kinds: what one call of a traffic mix does, one module a kind
(``calls/<kind>.py``), named by a mix's ``call`` key. See ``drive.py``."""

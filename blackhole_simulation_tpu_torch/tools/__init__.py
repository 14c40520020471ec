"""Measurement scripts for the port on the card (counterparts of the repo's
``tools/``); nothing in the package imports them."""

"""FITS reading and writing, and the streaming stack loader."""

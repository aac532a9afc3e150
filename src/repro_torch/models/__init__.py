"""Model zoo of the port: the paper's CNN."""
from . import cnn

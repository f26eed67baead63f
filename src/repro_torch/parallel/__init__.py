"""Mesh helpers: logical-axis sharding rules and the GPipe stage schedule."""
from . import sharding

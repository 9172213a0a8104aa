"""The benchmark's own tests (CPU; the card's carry the ``cuda`` marker)."""

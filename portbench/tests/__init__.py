"""The benchmark's own tests (CPU; the card tests skip without a card)."""

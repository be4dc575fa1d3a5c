"""The roofline of the port's steps on an H100: ``hardware`` (the card's
rates), ``counter`` (one ring member's FLOPs, bytes and collectives of a
step, counted as it runs), ``analysis`` (the three-term roofline of a
dry-run or counted record) and ``report`` (its table, a CLI)."""

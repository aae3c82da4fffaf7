"""State taxonomy, energy accounting, power models, the Algorithm-1 controller,
density clustering and pre-idle cause attribution."""

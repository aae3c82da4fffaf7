"""State taxonomy, energy accounting, power models and the Algorithm-1 controller."""

"""Models: LSH indexes and the recommendation engine."""

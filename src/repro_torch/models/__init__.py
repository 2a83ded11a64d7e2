"""Dense decoder layers, parameter trees, decode caches and weight transfer."""

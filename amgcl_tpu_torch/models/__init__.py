"""The AMG hierarchy and the make_solver bundle."""

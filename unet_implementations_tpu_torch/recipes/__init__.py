"""Entry points a user calls: the serving path."""

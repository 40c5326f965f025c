"""Federated rounds in the port: population and sampling (numpy), the
client step and the canonical cohort reduction, and the host trainer."""

"""The federated round engine."""

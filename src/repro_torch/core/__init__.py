"""DP-FedAvg's server side in the port: clipping, the server optimizers,
Algorithm 1's round finalisation and the RDP accountant."""

"""Model and run configurations (the architectures the port serves)."""

"""The port's job path: work dir, search job, result storage and CLI."""

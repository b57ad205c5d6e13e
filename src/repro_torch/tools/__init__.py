"""Model tools of the port: the §III depth surgeon."""

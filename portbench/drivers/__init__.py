"""Window loops over the port's entries, one file a traffic mix's driver."""

"""Column ops of the port: hashing, segmented scans, the merge join and the
dense-domain bitmap count."""

"""What runs a traffic mix: a workload file's ``entry`` names one of these modules."""

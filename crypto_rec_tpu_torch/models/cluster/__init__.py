"""k-means / k-means++ clustering: init, assignment, update, silhouette."""
